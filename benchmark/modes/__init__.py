"""Decode modes: one module per mode a traffic file names (``mode``), found
by that name.  Each holds all the benchmark knows of its mode:

* ``device_stage(exp, hist, readout, precision)`` -> (correction (S, n),
  ship (S,) bool): the reference's fixed-iteration stage on every shot;
* ``host_stage(exp, hist, readout, precision)`` -> correction, where the
  mode ships shots to a BP+OSD redecode;
* ``program_answer(exp, stages)`` -> (correction, ship) of the program's
  device stage, composed from the outputs of its BP stages as the entry
  captured them (``(kind, hard, conv)`` in call order), or None;
* ``NUMBERS`` and ``compare(exp, kept, device_precision, host_precision)``:
  the check's numbers of one kept batch (:mod:`benchmark.check`);
* ``control_batch(exp, record, device_precision, host_precision)``: the
  reference in the program's place, a kept batch in ``compare``'s form;
* ``bound_ms(h, rounds, shots, iters)``: the least time of a batch's
  device decode (:mod:`benchmark.work`).
"""

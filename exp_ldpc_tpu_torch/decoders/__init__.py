"""Decoding stack: batched BP (plain PyTorch + CUDA kernels), relay-BP
ensembles, OSD post-processing, spacetime/DEM matrix builders, and
decode-mode drivers.  The names and ``__all__`` of
``exp_ldpc_tpu/decoders/__init__.py``.
"""
from .bp import BPDecoder, bp_decode_batch, priors_to_llr
from .bp_bsr_spacetime import SpacetimeBSRDecoder
from .bp_int8 import Int8BPDecoder
from .bposd import BPOSDDecoder
from .flip import FlipDecoder, SmallSetFlipDecoder
from .qc_bp import QCBPDecoder, QCStructure
from .select import (make_bp_decoder, make_spacetime_bp_decoder,
                     qc_kwargs_for_code, qc_kwargs_single_shot)
from .osd import osd_decode, osd_decode_batch
from .relay_bp import RelayBPDecoder, relay_bp_decode_batch
from .spacetime import DetectorSpacetimeCode, SpacetimeCode, SpacetimeCodeSingleShot
from .spacetime_bp import SpacetimeBPDecoder
from .tanner import TannerELL
# last: bp_bsr_shard imports ..parallel.mesh, whose package imports
# ..parallel.pipeline and through it most of the modules above, which must
# be whole by then
from .bp_bsr_shard import ShardedBSR, ShardedBSRDecoder

__all__ = [
    "BPDecoder",
    "ShardedBSR",
    "ShardedBSRDecoder",
    "Int8BPDecoder",
    "BPOSDDecoder",
    "FlipDecoder",
    "SmallSetFlipDecoder",
    "QCBPDecoder",
    "QCStructure",
    "make_bp_decoder",
    "make_spacetime_bp_decoder",
    "qc_kwargs_for_code",
    "qc_kwargs_single_shot",
    "SpacetimeBPDecoder",
    "SpacetimeBSRDecoder",
    "RelayBPDecoder",
    "TannerELL",
    "SpacetimeCode",
    "SpacetimeCodeSingleShot",
    "DetectorSpacetimeCode",
    "bp_decode_batch",
    "relay_bp_decode_batch",
    "osd_decode",
    "osd_decode_batch",
    "priors_to_llr",
]

"""The benchmark's CPU tests decode tens of thousands of shots in plain
PyTorch, whose large temporaries glibc would map and unmap on every
iteration: keep freed memory in the heap instead (a test process only)."""
import ctypes
import ctypes.util

_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3

try:
    _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    _libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    _libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
    _libc.mallopt(_M_TRIM_THRESHOLD, (1 << 31) - 1)
except (OSError, AttributeError):   # not glibc: the tests only run slower
    pass

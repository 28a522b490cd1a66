"""The hand-written CUDA kernels of the port, their plain PyTorch versions,
and the build that turns `csrc/*.cu` into shared libraries.

Each wrapper takes the plain version for a tensor that lies on the CPU
and launches its CUDA kernel for a tensor on the card; there is no other
path.  Every launch adds one to the wrapper's `launches` count and to
its shape's count (length, dtype, and the op or bit range; for K1 the
length and each column's (dtype, op)) in the wrapper's `shapes`
Counter.  Each wrapper
also names its `source` under csrc/ and the TPU kernel it `replaces`.

  * K1 `seg_scan` (csrc/seg_scan.cu) replaces pallas_kernels.seg_agg_1d:
    segmented inclusive running sum/min/max over ascending group ids, of
    up to 8 value columns in one pass.
  * K2 `cumsum` (csrc/cumsum.cu) replaces pallas_kernels.cumsum_1d:
    inclusive prefix sum of int32/int64, wrapping.
  * K3 `sort_words` (csrc/radix_sort.cu) replaces
    pallas_kernels.bitonic_sort_u64: ascending sort of 64-bit words
    compared as unsigned (int64 storage), length a power of two; an LSD
    radix sort over the bits the caller names (`bits`).

The kernels are built at first use with one `nvcc` per source, all
started together, into `_build/` beside this package (a plain C
interface, loaded with ctypes).  A library's name carries a hash of its
source (each includes no header of its own), so an edited kernel is
rebuilt.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# library name -> (source, C function, argtypes, scratch-size function and
# its argtypes): the library reports the scratch its launch needs, so sizes
# live in the CUDA source alone
_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_LIBS = {
    "seg_scan": ("seg_scan.cu", "srt_seg_scan",
                 [_P, _P, _P, _P, _P, _I, _P, _N, _P],
                 ("srt_seg_scan_scratch_bytes", [_N, _I])),
    "cumsum": ("cumsum.cu", "srt_cumsum", [_P, _P, _P, _N, _I, _P],
               ("srt_cumsum_scratch_bytes", [_N, _I])),
    "radix_sort": ("radix_sort.cu", "srt_radix_sort",
                   [_P, _P, _P, _N, _I, _I, _P],
                   ("srt_radix_scratch_bytes", [_N, _I, _I])),
}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
_SCRATCH: Dict[str, ctypes._CFuncPtr] = {}
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    src = _LIBS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, src), "rb") as f:
        h.update(src.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build() -> float:
    """Compile every kernel library that is missing (one nvcc process per
    source, run in parallel) and load all of them.  Returns the seconds
    spent; raises with the compiler's output if a build fails."""
    t0 = time.perf_counter()
    with _BUILD_LOCK:
        if len(_FUNCS) == len(_LIBS):
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name, (src, *_rest) in _LIBS.items():
            path = _lib_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for name, path, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{name}: nvcc exit {p.returncode}\n"
                              f"{out.decode(errors='replace')}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name, (src, fn_name, argtypes, scratch) in _LIBS.items():
            lib = ctypes.CDLL(_lib_path(name))
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            size = getattr(lib, scratch[0])
            size.argtypes = scratch[1]
            size.restype = ctypes.c_longlong
            _SCRATCH[name] = size
            _FUNCS[name] = fn
    return time.perf_counter() - t0


def _func(name: str):
    if name not in _FUNCS:
        build()
    return _FUNCS[name]


@functools.lru_cache(maxsize=1024)
def _scratch_bytes(name: str, *args: int) -> int:
    _func(name)
    return _SCRATCH[name](*args)


def _scratch(name: str, device: torch.device, *args: int
             ) -> Optional[torch.Tensor]:
    """The scratch the library in _LIBS[name] asks for, or None (a null
    pointer) when it asks for none, as K3's tile route does."""
    size = _scratch_bytes(name, *args)
    return torch.empty(size, dtype=torch.uint8, device=device) if size \
        else None


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _kernel(fn, lib: str, replaces: str):
    """Mark `fn` as the wrapper of the kernel in _LIBS[lib]."""
    fn.launches = 0
    fn.shapes = collections.Counter()
    fn.source = os.path.relpath(os.path.join(CSRC, _LIBS[lib][0]),
                                os.path.dirname(_PKG))
    fn.replaces = replaces
    return fn


def _on_card(x: torch.Tensor, what: str, dtypes: Sequence[torch.dtype]
             ) -> bool:
    """True for a CUDA tensor the kernel takes, False for a CPU tensor
    (the plain version's); raises for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {x.dtype} not in {list(dtypes)}")
    if x.dim() != 1:
        raise ValueError(f"{what}: expected a 1-D tensor, got {x.dim()}-D")
    return True


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# --------------------------------------------------------------------------
# K2: prefix sum
# --------------------------------------------------------------------------

def cumsum_plain(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum in v's own integer type (wraps on overflow)."""
    return torch.cumsum(v, 0, dtype=v.dtype)


def cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of an int32/int64 column (K2 on the card)."""
    if not _on_card(v, "cumsum", (torch.int32, torch.int64)):
        return cumsum_plain(v)
    v = v.contiguous()
    n = v.numel()
    out = torch.empty_like(v)
    if n == 0:
        return out
    scratch = _scratch("cumsum", v.device, n, v.element_size())
    with torch.cuda.device(v.device):
        _check(_func("cumsum")(v.data_ptr(), out.data_ptr(),
                               _ptr(scratch), n, v.element_size(),
                               _stream(v)), "cumsum")
    _count(cumsum, (n, v.dtype))
    return out


_kernel(cumsum, "cumsum", "spark_rapids_tpu/ops/pallas_kernels.py:63")


# --------------------------------------------------------------------------
# K1: segmented running aggregate
# --------------------------------------------------------------------------

SEG_OPS = ("sum", "min", "max")
# columns one launch takes: SS_MAX_COLS in csrc/seg_scan.cu, and the codes
# below are its Column descriptor's (a CPU test holds them equal).  The
# largest request set the aggregates send, _minmax's float Min, has 2.
SEG_MAX_COLUMNS = 8
_SEG_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}
_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def _sweep(gid: torch.Tensor, v: torch.Tensor, op: str) -> torch.Tensor:
    """Segmented inclusive scan of one column as a log-step
    (Hillis-Steele) sweep: at distance d every row folds in the row d
    above it when both carry the same gid."""
    comb = _COMBINE[op]
    n = v.numel()
    d = 1
    while d < n:
        same = torch.zeros(n, dtype=torch.bool, device=v.device)
        same[d:] = gid[d:] == gid[:-d]
        shifted = torch.empty_like(v)
        shifted[d:] = v[:-d]
        shifted[:d] = v[:d]
        v = torch.where(same, comb(shifted, v), v)
        d *= 2
    return v


def seg_scan_plain(gid: torch.Tensor, vals: Sequence[torch.Tensor],
                   ops: Sequence[str]) -> List[torch.Tensor]:
    """seg_scan's function, one log-step sweep per column.  Restarts at
    each boundary, like the kernel."""
    return [_sweep(gid, v, op) for v, op in zip(vals, ops)]


def seg_scan(gid: torch.Tensor, vals: Sequence[torch.Tensor],
             ops: Sequence[str]) -> List[torch.Tensor]:
    """For each column of `vals` (int32, int64, float32 or float64, mixed
    dtypes allowed), the running `ops[i]` ("sum", "min" or "max") within
    each run of equal ascending `gid` (int32): the value at a run's last
    row is the run's reduction.  One K1 launch on the card for all the
    columns, as pallas_kernels.seg_agg_1d takes them."""
    vals, ops = list(vals), list(ops)
    if not vals or len(vals) != len(ops):
        raise ValueError(f"seg_scan: {len(vals)} columns, {len(ops)} ops")
    if len(vals) > SEG_MAX_COLUMNS:
        raise ValueError(f"seg_scan: {len(vals)} columns, at most "
                         f"{SEG_MAX_COLUMNS} a launch")
    for v, op in zip(vals, ops):
        if op not in SEG_OPS:
            raise ValueError(f"seg_scan: unknown op {op!r}")
        if v.shape != gid.shape:
            raise ValueError(f"seg_scan: gid {tuple(gid.shape)} vs values "
                             f"{tuple(v.shape)}")
    on_card = [_on_card(v, "seg_scan", tuple(_SEG_DTYPES)) for v in vals]
    if not any(on_card):
        return seg_scan_plain(gid, vals, ops)
    if not all(on_card) or any(v.device != gid.device for v in vals) \
            or gid.dtype != torch.int32:
        raise TypeError("seg_scan: gid must be int32, on the device of "
                        "every column")
    gid = gid.contiguous()
    vals = [v.contiguous() for v in vals]
    outs = [torch.empty_like(v) for v in vals]
    n, k = gid.numel(), len(vals)
    if n == 0:
        return outs
    scratch = _scratch("seg_scan", gid.device, n, k)
    with torch.cuda.device(gid.device):
        _check(_func("seg_scan")(
            gid.data_ptr(), (_P * k)(*[v.data_ptr() for v in vals]),
            (_P * k)(*[o.data_ptr() for o in outs]),
            (_I * k)(*[_SEG_DTYPES[v.dtype] for v in vals]),
            (_I * k)(*[SEG_OPS.index(op) for op in ops]), k, _ptr(scratch),
            n, _stream(gid)), "seg_scan")
    _count(seg_scan, (n, tuple((v.dtype, op) for v, op in zip(vals, ops))))
    return outs


_kernel(seg_scan, "seg_scan", "spark_rapids_tpu/ops/pallas_kernels.py:151")


# --------------------------------------------------------------------------
# K3: sort of 64-bit words
# --------------------------------------------------------------------------

_SIGN = -(1 << 63)


def sort_words_plain(words: torch.Tensor,
                     bits: Tuple[int, int] = (0, 64)) -> torch.Tensor:
    """Ascending unsigned order of int64-stored words: flip the sign bit,
    sort as signed, flip back.  Sorts whole words and ignores `bits`, so
    it checks the caller's promise as well as the kernel."""
    return torch.sort(words ^ _SIGN).values ^ _SIGN


def sort_words(words: torch.Tensor,
               bits: Tuple[int, int] = (0, 64)) -> torch.Tensor:
    """Ascending sort of int64 words compared as unsigned 64-bit values;
    the length must be a power of two (K3 on the card).

    `bits=(lo, hi)` is the caller's promise: all words agree on bits >= hi,
    and words that agree on bits >= lo already come in ascending order of
    bits < lo.  Under it a stable sort on bits [lo, hi) alone, which is
    what the kernel does, gives the full sort."""
    lo, hi = bits
    if not 0 <= lo <= hi <= 64:
        raise ValueError(f"sort_words: bits {bits} not within 0 <= lo <= "
                         f"hi <= 64")
    if not _on_card(words, "sort_words", (torch.int64,)):
        return sort_words_plain(words, bits)
    n = words.numel()
    if n == 0 or n & (n - 1):
        raise ValueError(f"sort_words: length {n} is not a power of two")
    words = words.contiguous()
    out = torch.empty_like(words)
    scratch = _scratch("radix_sort", words.device, n, lo, hi)
    with torch.cuda.device(words.device):
        _check(_func("radix_sort")(words.data_ptr(), out.data_ptr(),
                                   _ptr(scratch), n, lo, hi,
                                   _stream(words)), "sort_words")
    _count(sort_words, (n, words.dtype, lo, hi))
    return out


_kernel(sort_words, "radix_sort",
        "spark_rapids_tpu/ops/pallas_kernels.py:262")

KERNELS = (seg_scan, cumsum, sort_words)


def _count(fn, shape: tuple) -> None:
    """One launch of `fn`'s kernel at `shape`."""
    fn.launches += 1
    fn.shapes[shape] += 1


def reset_launches() -> None:
    """Set every launch count to 0 and forget the shapes launched."""
    for k in KERNELS:
        k.launches = 0
        k.shapes.clear()


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def built_libraries() -> List[str]:
    return [_lib_path(n) for n in _LIBS]

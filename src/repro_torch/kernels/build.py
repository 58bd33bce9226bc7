"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at
the repository root (listed in ``.gitignore``), built at first use from
the repository's sources only.  The hash covers the sources, the shared
header and the flags, so an edited source never loads a stale library.
:func:`build_all` starts one ``nvcc`` per source, all at once, and
waits for them together.

Each library has a plain C interface: every pointer and the stream are
``c_void_p``, and every entry returns ``cudaGetLastError()`` so that
the wrapper can raise on a launch that was refused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point and its argument types, per source.  The two stats
#: kernels launch one thread-block cluster a row through
#: ``cudaLaunchKernelEx``; the cluster size P <= 8 is portable, so it is
#: a field of each call's launch config and no function attribute is set
SIGNATURES = {
    "fused_stats": ("fused_stats_launch",
                    (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P)),
    "gram_update": ("gram_strip_launch",
                    (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                     _I, _P)),
    "pairwise": ("pairwise_launch",
                 (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P)),
    "hetero_entropy": ("entropy_launch", (_P, _P, _I, _I, _I, _F, _I, _P)),
    "decode_attention": ("decode_attention_launch",
                         (_P, _P, _P, _P, _P, _P) + (_I,) * 11
                         + (_I, _F, _I, _P)),
}

_loaded: dict = {}

#: kernel launches per source since the last :func:`reset_launches`;
#: each wrapper adds one where it launches its kernel, and nowhere else
#: (a launch recorded into a CUDA graph counts at each replay:
#: ``fed.server.RoundGraph``)
launches = {name: 0 for name in SIGNATURES}

#: the variants a source compiles in, by axis: the Gram kernels'
#: operand modes (``gram_in_bf16``) and the strip kernel's epilogues
OPERANDS = ("f32", "bf16")
VARIANTS = {"gram_update": {"epilogue": ("arccos", "cosine", "l2"),
                            "operands": OPERANDS},
            "pairwise": {"operands": OPERANDS}}
#: the same launches split by variant: {name: {axis: {variant: count}}}
variant_launches = {name: {axis: {v: 0 for v in vs}
                           for axis, vs in axes.items()}
                    for name, axes in VARIANTS.items()}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for axes in variant_launches.values():
        for counts in axes.values():
            for v in counts:
                counts[v] = 0


def counts() -> dict:
    """A copy of every count: {"launches": ..., "variants": ...}."""
    return {"launches": dict(launches),
            "variants": {name: {axis: dict(c) for axis, c in axes.items()}
                         for name, axes in variant_launches.items()}}


def counts_since(before: dict) -> dict:
    """The launches counted since ``before`` (a :func:`counts`)."""
    now = counts()
    return {"launches": {k: v - before["launches"][k]
                         for k, v in now["launches"].items()},
            "variants": {
                name: {axis: {v: n - before["variants"][name][axis][v]
                              for v, n in c.items()}
                       for axis, c in axes.items()}
                for name, axes in now["variants"].items()}}


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (a :func:`counts_since`) to the
    counts: a CUDA graph's replay adds the launches its capture
    recorded, and the capture, which launches nothing, takes them
    back."""
    for k, v in delta["launches"].items():
        launches[k] += sign * v
    for name, axes in delta["variants"].items():
        for axis, c in axes.items():
            for v, n in c.items():
                variant_launches[name][axis][v] += sign * n


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=tuple(SIGNATURES)) -> dict:
    """Compile every missing library, one ``nvcc`` process per source,
    all started together.  Returns {name: ptxas report}; raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def entry(name: str):
    """The C entry point of ``csrc/<name>.cu``, building on first use."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build_all()
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return _loaded[name]


def launch(name: str, *args, **variant: str) -> None:
    """Call ``csrc/<name>.cu``'s entry on the current stream, raise on
    a CUDA error code, and count the launch, and under each of its
    ``variant`` axes for a source listed in :data:`VARIANTS` (e.g.
    ``epilogue="l2", operands="bf16"``).  ``args`` are the entry's
    arguments without the trailing stream."""
    stream = torch.cuda.current_stream().cuda_stream
    err = entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err}")
    launches[name] += 1
    for axis, v in variant.items():
        variant_launches[name][axis][v] += 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def require(t: torch.Tensor, what: str, shape: tuple,
            dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: the kernels index raw row-major memory."""
    if not t.is_cuda:
        raise ValueError(f"{what} must lie on a CUDA device, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")

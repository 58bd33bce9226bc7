"""Rules of the PyTorch port that no parity test would catch.

* The port, ``chip_smoke.py`` and ``tools/{strip,decode,stats}_profile.py``
  import neither JAX nor anything of the JAX package ``repro``; the
  telemetry package is among them, and its ``trace.py`` imports nothing
  of the port.
* The kernel modules import without ``triton`` and without ``nvcc``.
* Entry points default to the card (the ops, the selector factories,
  the experiment builder, model init, the serve entry point, the sweep
  and the async server): called with no device on a machine without
  CUDA they raise instead of running on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "tools" / f"{name}_profile.py"
        for name in ("strip", "decode", "stats", "pairwise")]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_no_reference_imports():
    files = _port_files()
    assert len(files) > 20 and all(p.exists() for p in files)
    bad = [f"{p.relative_to(ROOT)} imports {mod}" for p in files
           for mod in _imported_modules(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_kernel_modules_import_without_triton_or_nvcc(tmp_path):
    """A fresh interpreter with ``triton`` blocked and no ``nvcc`` on
    PATH imports every kernel module and builds nothing."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.fused_stats\n"
        "import repro_torch.kernels.gram_update\n"
        "import repro_torch.kernels.pairwise\n"
        "import repro_torch.kernels.hetero_entropy\n"
        "import repro_torch.kernels.decode_attention\n"
        "from repro_torch.kernels import build\n"
        "import repro_torch.fed, repro_torch.core\n"
        "import repro_torch.core.selectors.baselines\n"
        "import repro_torch.models, repro_torch.launch.serve\n"
        "assert build._loaded == {} and not any(build.launches.values())\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_telemetry_package_is_covered_and_trace_is_a_leaf():
    """The telemetry package is among the files held to no JAX and no
    ``repro``, and ``trace.py``, which the kernel ops import, imports
    nothing of ``repro_torch`` (nor JAX, nor the reference)."""
    tel = sorted((PORT / "telemetry").glob("*.py"))
    assert [p.name for p in tel] == ["__init__.py", "export.py",
                                     "metrics.py", "trace.py"]
    assert set(tel) <= set(_port_files())
    trace = PORT / "telemetry" / "trace.py"
    tree = ast.parse(trace.read_text())
    assert not [n for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level > 0]
    bad = [mod for mod in _imported_modules(trace)
           if mod.split(".")[0] in ("repro_torch", "repro", "jax",
                                    "jaxlib")]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_without_device_raises_without_cuda(no_cuda):
    from repro_torch.fed import ExperimentSpec, build
    spec = ExperimentSpec(num_clients=4, num_select=2, rounds=1,
                          samples_train=40, samples_test=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(spec)


def test_ops_without_device_raise_without_cuda(no_cuda):
    from repro_torch.kernels import ops
    x = torch.zeros(4, 10)
    calls = [
        lambda: ops.fused_row_stats(x, 0.63),
        lambda: ops.hics_selection_step(x, 0.63),
        lambda: ops.pairwise_distances(x, 0.63),
        lambda: ops.hics_selection_step_cached(
            x, torch.zeros(4, 4), torch.zeros(4, 2),
            torch.arange(2), 0.63),
        lambda: ops.estimate_entropies(x, 0.0025),
        lambda: ops.gqa_decode_attention(
            torch.zeros(1, 4, 8), torch.zeros(1, 3, 2, 8),
            torch.zeros(1, 3, 2, 8), 3),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_make_metrics_without_device_raises_without_cuda(no_cuda):
    """The telemetry step is made for the card unless told otherwise."""
    from repro_torch.telemetry import MetricsSpec, make_metrics
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_metrics(MetricsSpec.all(), num_clients=4)


def test_baseline_entry_points_raise_without_cuda(no_cuda):
    """The strip's epilogue ops, the full-update step and every selector
    factory default to the card."""
    from repro_torch.core import FUNCTIONAL, make_functional
    from repro_torch.kernels import ops
    x = torch.zeros(4, 10)
    stats, ids = torch.ones(4, 2), torch.arange(2)
    calls = [
        lambda: ops.gram_row_update(x, stats, ids, epilogue="cosine"),
        lambda: ops.gram_row_update(x, stats, ids, epilogue="l2"),
        lambda: ops.cached_feature_step(x, torch.zeros(4, 4), stats, ids),
        lambda: ops.cached_feature_step(x, torch.zeros(4, 4), stats, ids,
                                        "l2"),
    ] + [lambda name=name: make_functional(name, num_clients=4,
                                           num_select=2, total_rounds=3)
         for name in FUNCTIONAL]
    assert len(calls) == 10
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_set_precision_full_f32_and_deterministic():
    """The builder's precision settings: no TF32 anywhere, and only
    deterministic cuDNN algorithms, so a card run can be repeated."""
    from repro_torch.backend import set_precision
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.deterministic = False
        set_precision()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.deterministic
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved[:3]
        torch.set_float32_matmul_precision(saved[3])


def test_layer_helpers_take_an_explicit_device():
    """No helper of the LM layers places a tensor on a device of its own
    choosing: the device is a required argument."""
    import inspect
    from repro_torch.models import layers
    for fn in (layers.init_norm, layers.rope_frequencies):
        param = inspect.signature(fn).parameters["device"]
        assert param.default is inspect.Parameter.empty, fn.__name__
    assert layers.rope_frequencies(8, 1e4, "cpu").device.type == "cpu"
    with pytest.raises(TypeError):
        layers.init_norm(8, "rmsnorm")


def test_serve_entry_points_raise_without_cuda(no_cuda):
    """Model init, the cache and the serve entry point default to the card."""
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    api = get_model("qwen2.5-3b")
    calls = [lambda: api.init(0), lambda: api.init_cache(1, 8),
             lambda: serve.main(["--full"]), lambda: serve.main([])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_scenario_entry_points_raise_without_cuda(no_cuda):
    """The sweep's drivers, its dataset, the servers built from a
    partition and the async server default to the card."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.fed import (AsyncConfig, AsyncFederatedServer,
                                 FedConfig, FederatedServer)
    from repro_torch.models import make_classifier
    from repro_torch.scenarios import (SCENARIOS, SweepSpec,
                                       build_async_pair, build_pair,
                                       make_dataset, materialize,
                                       run_async_sweep, run_host_reference,
                                       run_sweep)
    spec = SweepSpec(scenarios=("mixed_80_20",), selectors=("hics",),
                     seeds=(0,), num_clients=4, num_select=2, rounds=1,
                     samples_train=40, samples_test=10)
    scn = SCENARIOS["mixed_80_20"]
    init, apply, _ = make_classifier(get_config("paper-mlp"), 4)
    x, y = np.zeros((40, 4), np.float32), np.zeros(40, np.int32)
    part = materialize(scn, 0, {"y": torch.tensor(y)}, 10, 4, 10)
    cx, cm = np.zeros((4, 10, 4), np.float32), np.ones((4, 10), np.float32)
    calls = [
        lambda: run_sweep(spec), lambda: run_async_sweep(spec),
        lambda: build_pair(spec, "mixed_80_20", "hics"),
        lambda: build_async_pair(spec, "mixed_80_20", "hics"),
        lambda: run_host_reference(spec, "mixed_80_20", "hics", 0),
        lambda: make_dataset(scn, 40, 10, 10),
        lambda: FederatedServer.from_partition(
            init, apply, FedConfig(num_clients=4, num_select=2), x, y,
            part),
        lambda: AsyncFederatedServer(
            init, apply, AsyncConfig(num_clients=4, num_select=2), cx,
            np.zeros((4, 10), np.int32), cm),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_wrappers_refuse_cpu_tensors_at_launch():
    """The raw launch functions never run on the CPU: a CPU tensor is
    refused before any library is built or loaded."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_stats import fused_stats_rows
    from repro_torch.kernels.gram_update import gram_strip
    from repro_torch.kernels.pairwise import pairwise
    from repro_torch.kernels.hetero_entropy import entropy_rows
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="CUDA"):
        fused_stats_rows(x, 0.63)
    with pytest.raises(ValueError, match="CUDA"):
        fused_stats_rows(x, 0.63, normalize=True, splits=3)
    with pytest.raises(ValueError, match="CUDA"):
        fused_stats_rows(x, 0.63, row_scale=torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        gram_strip(x[:2], x, torch.ones(2, 2), torch.ones(4, 2),
                   torch.zeros(2, dtype=torch.int32), 10.0)
    for epilogue in ("cosine", "l2"):
        with pytest.raises(ValueError, match="CUDA"):
            gram_strip(x[:2], x, torch.ones(2, 2), torch.ones(4, 2),
                       torch.zeros(2, dtype=torch.int32), 0.0,
                       epilogue=epilogue)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise(x, torch.ones(4, 2), 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise(x, torch.ones(4, 2), 10.0, gram_in_bf16=True)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise(x, torch.ones(4, 2), 10.0, splits=3)
    for epilogue in ("arccos", "cosine", "l2"):
        with pytest.raises(ValueError, match="CUDA"):
            gram_strip(x[:2], x, torch.ones(2, 2), torch.ones(4, 2),
                       torch.zeros(2, dtype=torch.int32), 0.0,
                       epilogue=epilogue, gram_in_bf16=True, splits=1)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_rows(x, 0.0025)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_rows(x.bfloat16(), 0.0025)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_rows(x, 0.0025, splits=8)
    kv = torch.zeros(1, 3, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel(torch.zeros(1, 4, 8), kv, kv,
                                torch.ones(1, dtype=torch.int32), 0.35)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel(torch.zeros(1, 4, 8), kv.bfloat16(),
                                kv.bfloat16(),
                                torch.ones(1, dtype=torch.int32), 0.35)
    assert not build._loaded and not any(build.launches.values())


def test_decode_kernel_layout_fits_the_card():
    """Every (G, dh, cache type) the decode kernel takes fits a block's
    shared memory with at least one block an SM, the warps' merge fits
    in the ring it reuses (the source's static_assert), and the wrapper
    refuses a CPU tensor, f32 or bf16, before it builds or loads
    anything."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    for dh in da.HEAD_DIMS:
        for g in range(1, 17):
            if da.group_pad(g) * dh > da.MAX_GROUP_WIDTH:
                continue
            for elt in (2, 4):
                smem = da.smem_bytes(g, dh, elt)
                assert smem <= da.SMEM_LIMIT
                assert 1 <= da.resident_blocks(g, dh, elt) <= da.MAX_RESIDENT
                ring = da.WARPS * da.STAGES * 2 * da.PW * dh * elt
                assert 4 * da.WARPS * da.group_pad(g) * (dh + 2) <= ring
    kv = torch.zeros(1, 64, 2, 64)
    for cache in (kv, kv.bfloat16()):
        with pytest.raises(ValueError, match="CUDA"):
            da.decode_attention_kernel(torch.zeros(1, 4, 64), cache, cache,
                                       torch.ones(1, dtype=torch.int32),
                                       0.125)
    assert not build._loaded and not any(build.launches.values())


def test_gram_in_bf16_entry_points_raise_without_cuda(no_cuda):
    """The option does not move an entry point off the card."""
    from repro_torch.core import make_functional
    from repro_torch.kernels import ops
    x = torch.zeros(4, 10)
    stats, ids = torch.ones(4, 2), torch.arange(2)
    calls = [
        lambda: ops.hics_selection_step(x, 0.63, gram_in_bf16=True),
        lambda: ops.pairwise_distances(x, 0.63, gram_in_bf16=True),
        lambda: ops.hics_selection_step_cached(
            x, torch.zeros(4, 4), stats, ids, 0.63, gram_in_bf16=True),
        lambda: ops.gram_row_update(x, stats, ids, gram_in_bf16=True),
        lambda: ops.cached_feature_step(x, torch.zeros(4, 4), stats, ids,
                                        "l2", gram_in_bf16=True),
        lambda: make_functional("hics", num_clients=4, num_select=2,
                                total_rounds=3, gram_in_bf16=True),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_signatures_match_the_c_entries():
    """Each library's ctypes binding (``build.SIGNATURES``) names the C
    entry that its source defines, with one argument type a parameter
    in the order the source declares them: pointers and the stream as
    ``c_void_p``, ``int`` as ``c_int``, ``float`` as ``c_float``."""
    import ctypes
    import re

    from repro_torch.kernels import build
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    for name, (entry, argtypes) in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        found = re.search(r'extern "C" int (\w+)\(([^)]*)\)', src)
        assert found and found.group(1) == entry, name
        params = [re.sub(r"\bconst\b|\s+", "", p.rsplit(" ", 1)[0]
                         if "*" not in p else p.split("*")[0] + "*")
                  for p in found.group(2).split(",")]
        assert [kinds[p] for p in params] == list(argtypes), name
    # pairwise: x, stats, out, workspace, counters, n, c, splits, lam,
    # eps, bf16, stream
    assert len(build.SIGNATURES["pairwise"][1]) == 12


def test_launch_counts_by_variant(monkeypatch):
    """``build.launch`` counts a launch once per source and once under
    each of its variant axes (the Gram kernels' operand modes, the
    strip's epilogues); a CUDA error code raises and counts nothing."""
    from repro_torch.kernels import build

    class Stream:
        cuda_stream = 0

    codes = {"gram_update": 0, "pairwise": 0}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(build, "entry",
                        lambda name: lambda *args: codes[name])
    assert build.VARIANTS["gram_update"]["operands"] == ("f32", "bf16")
    assert build.VARIANTS["pairwise"] == {"operands": ("f32", "bf16")}
    build.reset_launches()
    try:
        build.launch("gram_update", epilogue="l2", operands="bf16")
        build.launch("gram_update", epilogue="arccos", operands="f32")
        build.launch("pairwise", operands="bf16")
        assert build.launches["gram_update"] == 2
        assert build.launches["pairwise"] == 1
        v = build.variant_launches
        assert v["gram_update"]["epilogue"] == {"arccos": 1, "cosine": 0,
                                                "l2": 1}
        assert v["gram_update"]["operands"] == {"f32": 1, "bf16": 1}
        assert v["pairwise"]["operands"] == {"f32": 0, "bf16": 1}
        codes["pairwise"] = 1
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            build.launch("pairwise", operands="f32")
        assert v["pairwise"]["operands"] == {"f32": 0, "bf16": 1}
        build.reset_launches()
        assert not any(build.launches.values())
        assert not any(c for axes in v.values() for counts in axes.values()
                       for c in counts.values())
    finally:
        build.reset_launches()

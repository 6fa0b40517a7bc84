"""The helpers that run the renderer on a GPU: the compile-cache rule,
the refusal to measure without a GPU, and chip_smoke's parity
comparator."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from restir_tpu.utils import compile_cache, device

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses resolve their module by name
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke")


@pytest.mark.parametrize("env_value,want", [
    ("/somewhere/else", None),
    (None, ROOT / ".jax_cache"),
])
def test_compile_cache_dir_rule(env_value, want):
    """With JAX_COMPILATION_CACHE_DIR set nothing is configured (JAX
    reads the variable); otherwise the cache is <repo>/.jax_cache."""
    environ = {} if env_value is None else {compile_cache.ENV_VAR: env_value}
    assert compile_cache.compile_cache_dir(environ) == want
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


@pytest.mark.parametrize("script", ["chip_smoke", "bench"])
def test_scripts_fail_without_gpu(script, capsys):
    """On a CPU-only process both scripts exit non-zero; chip_smoke
    prints no result line, bench prints its JSON line with an error."""
    mod = chip_smoke if script == "chip_smoke" else _load("bench")
    rc = mod.main([]) if script == "chip_smoke" else mod.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert rc != 0
    if script == "chip_smoke":
        assert not any('"ok": true' in line for line in out)
    else:
        last = json.loads(out[-1])
        assert last["value"] is None and "no GPU" in last["error"]


def _frame(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return (0.2 + rng.random((n, 3))).astype(np.float32)


TOL = chip_smoke.Tolerance(prim_agree=0.998, mean=0.02, rel_l1=0.05)


def _perturbed(kind):
    ref = _frame()
    prim = np.arange(ref.shape[0]) % 7
    got, got_prim = ref.copy(), prim.copy()
    if kind == "flips":  # a few decision flips: within tolerance
        got[:20] = _frame(1)[:20]
        got_prim[:4] = -1
    elif kind == "bias":  # 3 % darker everywhere
        got *= 0.97
    elif kind == "nan":
        got[5, 1] = np.nan
    elif kind == "silhouettes":  # 1 % of primary hits differ
        got_prim[: ref.shape[0] // 100] = -1
    return ref, got, prim, got_prim


@pytest.mark.parametrize("kind,ok", [
    ("identical", True), ("flips", True), ("bias", False),
    ("nan", False), ("silhouettes", False),
])
def test_parity_comparator(kind, ok):
    ref, got, prim, got_prim = _perturbed(kind)
    res = chip_smoke.compare_frames(ref, got, prim, got_prim, TOL)
    assert res["ok"] is ok, res
    if kind == "identical":
        assert res["prim_agree"] == 1.0 and res["rel_l1"] == 0.0

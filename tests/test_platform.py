"""What ties the program to its platform: the compilation-cache
directory rule, the GPU smoke script's refusal to run without a GPU and
its tolerance helpers, and the decoding of GPU runtime errors."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, drop=(), cwd=REPO, args=()):
    env = {k: v for k, v in os.environ.items()
           if k not in drop and k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    if "PYTHONPATH" not in drop:
        env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    cmd = [sys.executable] + (["-c", code] if code else []) + list(args)
    return subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=300)


_CACHE_PROBE = """
import os, jax, jax.numpy as jnp
from mini_opencl_raytracer.utils.cache import (DEFAULT_DIR,
                                              enable_persistent_cache)
path = enable_persistent_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.arange(7.0)).block_until_ready()
print("PATH", path)
print("CONFIG", jax.config.jax_compilation_cache_dir)
print("DEFAULT", DEFAULT_DIR)
"""


@pytest.mark.parametrize("branch", ["env_set", "env_unset"])
def test_compilation_cache_dir_rule(tmp_path, branch):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed,
    git-ignored directory inside the checkout."""
    if branch == "env_set":
        target = str(tmp_path / "jc")
        r = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": target})
        assert r.returncode == 0, r.stderr
        assert f"PATH {target}" in r.stdout
        assert f"CONFIG {target}" in r.stdout
        assert os.listdir(target), "nothing cached in the env directory"
    else:
        r = _run(_CACHE_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",))
        assert r.returncode == 0, r.stderr
        default = os.path.join(REPO, ".cache", "jax")
        assert f"PATH {default}" in r.stdout
        assert f"CONFIG {default}" in r.stdout
        assert os.listdir(default)
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert "/.cache/" in f.read().split()


@pytest.mark.parametrize("where", ["cpu_backend", "script_alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """No GPU (or no package beside the script): non-zero exit and no
    result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "script_alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        r = _run(None, cwd=str(tmp_path), args=["chip_smoke.py"],
                 drop=("PYTHONPATH",))
    else:
        r = _run(None, args=[script])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert ("no GPU" if where == "cpu_backend"
            else "No module named 'mini_opencl_raytracer'") in r.stderr


def test_chip_smoke_tolerance_helpers():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    b = np.ones((10, 10, 3))
    a = b.copy()
    a[0, 0, 1] += 0.5          # one pixel off in one channel
    a[1, 1] += 5e-4            # inside atol
    bad, max_abs = cs.frac_mismatch(a, b, atol=1e-3, rtol=0.0)
    assert bad == pytest.approx(0.01) and max_abs == pytest.approx(0.5)
    a[2, 2, 2] = np.nan
    assert cs.frac_mismatch(a, b, 1e-3, 0.0)[0] == pytest.approx(0.02)
    assert cs.frac_mismatch(b * 1.0005, b, atol=0.0, rtol=1e-3)[0] == 0.0
    with pytest.raises(ValueError):
        cs.frac_mismatch(b, b[0], 1e-3, 1e-3)
    assert cs.rel_l2(np.array([3.0, 4.0]), np.array([3.0, 4.0])) == 0.0
    assert cs.rel_l2(np.array([3.0, 5.0]),
                     np.array([3.0, 4.0])) == pytest.approx(0.2)
    assert cs.rel_l2(np.zeros(2), np.zeros(2)) == 0.0
    assert cs.rel_l2(np.array([3.0, 5.0]), np.array([3.0, 4.0]),
                     floor=10.0) == pytest.approx(0.1)
    with pytest.raises(cs.PhaseFailed):
        cs.check(False, "boom")
    # A leaf at rounding level against the whole gradient is judged
    # against the floor, not its own norm; a real error still fails.
    ref = {"big": np.array([0.6, 0.8]), "tiny": np.array([1e-9, 0.0])}
    test = {"big": ref["big"], "tiny": np.array([2e-9, 1e-9])}
    rec = cs._check_grads(test, ref)
    assert rec["grad_worst_leaf"] == "['tiny']"
    assert rec["grad_floor"] == pytest.approx(cs.GRAD_FLOOR)
    assert rec["grad_leaf_rel_l2_and_ref_norm"]["['tiny']"][1] == \
        pytest.approx(1e-9)
    with pytest.raises(cs.PhaseFailed, match="big"):
        cs._check_grads({"big": ref["big"] * 1.1, "tiny": ref["tiny"]}, ref)


@pytest.mark.parametrize("msg,cls", [
    ("RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
     "85899345920 bytes.", "DeviceOutOfMemoryError"),
    ("INTERNAL: Failed to allocate 1073741824 bytes: "
     "CUDA_ERROR_OUT_OF_MEMORY: out of memory", "DeviceOutOfMemoryError"),
    ("Unable to initialize backend 'cuda': FAILED_PRECONDITION: No visible "
     "GPU devices.", "NoAcceleratorError"),
    ("INTERNAL: CUDA error: Failed call to cuInit: CUDA_ERROR_NO_DEVICE: "
     "no CUDA-capable device is detected", "NoAcceleratorError"),
])
def test_decode_gpu_errors(msg, cls):
    from mini_opencl_raytracer.utils import errors
    e = errors.decode_error(RuntimeError(msg))
    assert type(e).__name__ == cls
    assert msg[:60] in str(e)

"""Multi-process exercise: 2 real processes x 4 virtual CPU devices.

Runs ``parallel/multihost.initialize`` for real — an explicit
coordinator, two OS processes, a global 8-device mesh spanning both —
and asserts a dp-sharded render's addressable shards match a
single-device render of the same sample (SURVEY.md section 5
'Distributed communication backend'; the reference has no multi-device
support at all). Skips when the sandbox forbids localhost port binding.
"""

import os
import socket
import subprocess
import sys

import pytest

_CHILD = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; repo = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

# Load multihost.py WITHOUT the package __init__ — importing the package
# builds jnp constants, which initializes the XLA backend and makes
# jax.distributed.initialize illegal. Real multi-host entrypoints call
# initialize() first for the same reason.
import importlib.util
spec = importlib.util.spec_from_file_location(
    "mh", os.path.join(repo, "mini_opencl_raytracer", "parallel",
                       "multihost.py"))
multihost = importlib.util.module_from_spec(spec)
spec.loader.exec_module(multihost)

ok = multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                          num_processes=2, process_id=pid)
assert ok, "initialize() returned False with explicit args"
pi, pc, local = multihost.process_info()
assert (pi, pc, local) == (pid, 2, 4), (pi, pc, local)
assert jax.device_count() == 8, jax.device_count()

import jax.numpy as jnp
from jax.sharding import Mesh
import mini_opencl_raytracer as mrt
from mini_opencl_raytracer.parallel import shard

scene = mrt.cornell_scene()
camera = mrt.Camera.default()
cfg = mrt.RenderConfig(width=64, height=64, bounces=2,
                       backend="bruteforce")

mesh = Mesh(np.asarray(jax.devices()).reshape(8, 1), ("dp", "tp"))
with mesh:
    img = shard.render_sample_dp(scene, camera, cfg, mesh, frame=0)

ref = np.asarray(mrt.render_sample(scene, camera, cfg, frame=0))
flat_ref = ref.reshape(-1, 3)
n_checked = 0
for s in img.addressable_shards:
    got = np.asarray(s.data).reshape(-1, 3)
    idx = s.index[0]
    want = flat_ref.reshape(img.shape)[idx].reshape(-1, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    n_checked += 1
assert n_checked == 4, n_checked
print(f"MULTIHOST_OK p{pid} shards={n_checked}")
"""


@pytest.mark.filterwarnings("ignore")
def test_two_process_dp_render(tmp_path):
    # Reserve a coordinator port.
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    except OSError:
        pytest.skip("localhost port binding unavailable")

    child = tmp_path / "mh_child.py"
    child.write_text(_CHILD)
    # Clean slate: no preset XLA/JAX env.
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    env["JAX_PLATFORMS"] = "cpu"

    procs = [subprocess.Popen(
        [sys.executable, str(child), str(pid), str(port), repo],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost children timed out")

    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and "Failed to connect" in out:
            pytest.skip("distributed service unavailable in sandbox")
        assert p.returncode == 0, f"child {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK p{pid}" in out, out[-3000:]

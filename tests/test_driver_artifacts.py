"""Entry-point contracts that need no device.

- chip_smoke.py and bench.py measure the GPU; without one they exit
  non-zero and print no result (no fallback that hides the device).
- The persistent compile cache honours JAX_COMPILATION_CACHE_DIR as given
  and otherwise lives at one fixed path inside the checkout.
- The dryrun parent re-execs to a CPU mesh without touching a backend.
"""

import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


@pytest.mark.parametrize("argv", [["chip_smoke.py"], ["bench.py", "--quick"]],
                         ids=["chip_smoke", "bench_quick"])
def test_gpu_entry_points_fail_without_gpu(argv):
    proc = subprocess.run([sys.executable] + argv, cwd=_REPO, env=_cpu_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0, proc.stdout[-2000:]
    assert '"ok": true' not in proc.stdout
    for line in proc.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(rec, dict) and ("metric" in rec or "ok" in rec)), line


_CACHE_PROBE = (
    "import nautilus_tpu, jax, jax.numpy as jnp\n"
    "jax.jit(lambda x: x * 2 + 1)(jnp.arange(3.0)).block_until_ready()\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


@pytest.mark.parametrize("from_env", [True, False], ids=["env", "default"])
def test_compile_cache_placement(tmp_path, from_env):
    env = _cpu_env(JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
                   JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
                   PYTHONPATH=os.pathsep.join(
                       [_REPO, os.environ.get("PYTHONPATH", "")]))
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "given")
    proc = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    used = proc.stdout.strip().splitlines()[-1]
    if from_env:
        assert used == str(tmp_path / "given")
    else:
        base = os.path.join(_REPO, ".jax_cache")
        assert os.path.dirname(used) == base
        assert os.path.basename(used).startswith("cpu-")
        ignored = subprocess.run(["git", "check-ignore", "-q", used],
                                 cwd=_REPO)
        assert ignored.returncode == 0, f"{used} is not gitignored"
    assert os.path.isdir(used) and os.listdir(used), "no cache entry written"


def test_dryrun_parent_never_initializes_a_backend(monkeypatch):
    """The parent half of dryrun_multichip must not call jax.devices().

    The parent decides purely from the environment and re-execs into a
    CPU child, so it never claims a device.  We assert by making backend
    initialization explode.
    """
    import jax

    sys.path.insert(0, _REPO)
    try:
        import __graft_entry__ as g
    finally:
        sys.path.pop(0)

    def boom(*a, **k):
        raise AssertionError("parent touched the backend")

    monkeypatch.setattr(jax, "devices", boom)
    monkeypatch.setattr(jax, "local_devices", boom, raising=False)
    seen = {}

    def fake_reexec(n):
        seen["n"] = n

    monkeypatch.delenv("NAUTILUS_DRYRUN_CHILD", raising=False)
    monkeypatch.setattr(g, "_reexec_on_virtual_mesh", fake_reexec)
    g.dryrun_multichip(8)
    assert seen["n"] == 8

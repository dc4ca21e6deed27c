"""nautilus_tpu — a human-in-the-loop 2D lidar pose-graph SLAM framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of ut-amrl/nautilus
(reference layout described in SURVEY.md).  The whole optimization is expressed
as pure functions over flat SE(2) pose arrays with fixed-shape (padded + masked)
factor arrays, jitted once and executed on the accelerator (an NVIDIA GPU):

- Ceres Levenberg-Marquardt (reference src/optimization/solver.cc:266-356)
  becomes a JAX LM loop with dense/CG normal-equation solves (solve/lm.py).
- Per-point KD-tree correspondence search (reference src/util/kdtree.cc)
  becomes batched masked nearest-neighbor matching (solve/correspond.py).
- Correlative scan matching (reference third_party CSM, used at
  src/optimization/solver.cc:630-649) becomes 2D correlation over
  rasterized lookup tables, left to XLA as matrix products (kernels/csm.py).
- ROS bag ingest (reference src/main.cc:46-129, src/input/) becomes a
  host-side bag-to-arrays layer with npz caching (ingest/).
- The Lua config surface (reference config/*.lua) is preserved verbatim via a
  small Lua-subset interpreter (core/luaconf.py).
"""

__version__ = "0.1.0"

import os as _os

# Persistent XLA compilation cache.  JAX_COMPILATION_CACHE_DIR, when set,
# is used as given (jax reads it itself) and no other directory is set in
# code.  When it is unset the cache lives at one fixed path inside the
# checkout, <repo>/.jax_cache (gitignored): the path is part of the cache
# key, so it must not move between runs.
#
# CPU-platform processes (the test suite and the multichip dryrun child
# both export JAX_PLATFORMS=cpu before jax initializes) get a subdirectory
# keyed by a CPU-feature fingerprint: XLA:CPU stores AOT artifacts
# specialized to the compile host's machine features, and loading them on a
# host with a different feature set is flagged as a potential SIGILL by
# cpu_aot_loader.

_CACHE_BASE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _host_cache_key():
    """Key the CPU-lane cache by CPU flags + jaxlib version + XLA_FLAGS:
    XLA:CPU AOT artifacts are specialized to all three, and deserializing
    an entry produced under a different combination (same cpuinfo,
    different XLA tuning flags) has segfaulted the suite."""
    import hashlib
    h = hashlib.sha1()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    h.update(line.encode())
                    break
    except Exception:
        import platform as _platform
        h.update((_platform.machine() or "default").encode())
    try:
        import jaxlib
        h.update(getattr(jaxlib, "__version__", "?").encode())
    except Exception:
        pass
    h.update(_os.environ.get("XLA_FLAGS", "").encode())
    return h.hexdigest()[:10]


def _cache_dir():
    if _os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return _os.path.join(_CACHE_BASE, "cpu-" + _host_cache_key())
    return _CACHE_BASE


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax
    _jax.config.update("jax_compilation_cache_dir", _cache_dir())

from nautilus_tpu.core.luaconf import load_config  # noqa: F401
from nautilus_tpu.core.problem import SLAMProblem, SLAMState  # noqa: F401

"""Shared set-up of the probe scripts: repo path, config, cached problem.

Run the scripts from anywhere (``python benchmarks/<name>.py``); this
directory is on sys.path then, so ``import _common`` works.
"""

import os
import pickle
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def default_config():
    from nautilus_tpu.core.luaconf import load_config
    return load_config(os.path.join(REPO, "config", "default_config.lua"))


def building_problem(nodes: int, beams: int):
    """bench.py's problem (building world, seed 1) at ``nodes`` poses.

    The synthetic raycast at N=5000 takes minutes of host time, so the
    built state is pickled under build/ (gitignored) and reused."""
    from nautilus_tpu.ingest.synthetic import make_problem
    cache = os.path.join(REPO, "build", f"problem_{nodes}_{beams}.pkl")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            state = pickle.load(f)
        print(f"problem loaded from cache: {time.perf_counter() - t0:.0f}s")
        return state
    state, _ = make_problem(num_nodes=nodes, world_kind="building",
                            num_beams=beams, seed=1,
                            odom_noise_trans=0.02, odom_noise_rot=0.008)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    with open(cache, "wb") as f:
        pickle.dump(state, f)
    print(f"problem build: {time.perf_counter() - t0:.0f}s")
    return state

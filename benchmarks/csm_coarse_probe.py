"""Probe: coarse-correlation formulations for the stage-major CSM engine.

The coarse rot-chunk scan step re-reads the im2col patches
([C, 225, 40000] f32 = 144 MB) every scan step, so it is expected to be
memory-bound.  Variants timed here at production shapes (C=4, rc=32,
table 214^2, kernel 200^2, offsets 15^2):

  A  im2col einsum f32 HIGHEST      (CSMParams(coarse_f32=True))
  B  im2col einsum bf16 operands    (the default: half the patch traffic)
  C  grouped conv f32 HIGHEST      (no patch materialization at all)
  D  grouped conv default precision

Argmax agreement vs A is checked for each variant over random tables —
the coarse stage only picks a cell for refinement, so argmax parity is
the correctness bar (final scores come from the fine stages).

Run on the GPU: python benchmarks/csm_coarse_probe.py
"""
import time

import _common  # noqa: F401

import numpy as np
import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

C, RC = 4, 32
T, KC = 214, 200
NOFF = T - KC + 1  # 15


def im2col(table):
    return jnp.stack(
        [jax.lax.dynamic_slice(table, (oy, ox), (KC, KC)).reshape(-1)
         for oy in range(NOFF) for ox in range(NOFF)], axis=0)


@jax.jit
def variant_a(rasters, patches):
    return jnp.einsum("brk,bok->bro", rasters.reshape(C, RC, -1), patches,
                      precision=HIGHEST)


@jax.jit
def variant_b(rasters, patches):
    out = jnp.einsum("brk,bok->bro",
                     rasters.reshape(C, RC, -1).astype(jnp.bfloat16),
                     patches.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    return out


def _grouped_conv(tables, rasters, precision):
    # input [1, C, T, T]; filters [C*RC, 1, KC, KC]; groups=C
    # -> output [1, C*RC, NOFF, NOFF]
    out = jax.lax.conv_general_dilated(
        tables[None], rasters.reshape(C * RC, 1, KC, KC),
        window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=C, precision=precision,
        preferred_element_type=jnp.float32)
    return out[0].reshape(C, RC, NOFF * NOFF)


@jax.jit
def variant_c(tables, rasters):
    return _grouped_conv(tables, rasters, HIGHEST)


@jax.jit
def variant_d(tables, rasters):
    return _grouped_conv(tables, rasters, jax.lax.Precision.DEFAULT)


def bench(label, fn, *args, ref=None, reps=5):
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    agree = ""
    if ref is not None:
        am = np.argmax(np.asarray(out, np.float32).reshape(C, -1), axis=1)
        am_ref = np.argmax(np.asarray(ref).reshape(C, -1), axis=1)
        agree = f"  argmax agree {np.mean(am == am_ref):.2%}"
    print(f"{label:32s}: {best*1e3:7.2f} ms{agree}")
    return out


def main():
    rng = np.random.default_rng(0)
    # Realistic magnitudes: log-occupancy tables in [-13.8, 0], rasters
    # are small point counts.
    tables = jnp.asarray(
        rng.uniform(-13.8, 0.0, (C, T, T)).astype(np.float32))
    rasters = jnp.asarray(
        (rng.random((C, RC, KC, KC)) < 0.003).astype(np.float32))
    patches = jax.jit(jax.vmap(im2col))(tables)
    jax.block_until_ready(patches)

    a = bench("A im2col einsum f32 HIGHEST", variant_a, rasters, patches)
    bench("B im2col einsum bf16", variant_b, rasters, patches, ref=a)
    bench("C grouped conv f32 HIGHEST", variant_c, tables, rasters, ref=a)
    bench("D grouped conv default", variant_d, tables, rasters, ref=a)


if __name__ == "__main__":
    main()

"""Block-band Cholesky solver for the SLAM normal equations.

The pose graph's lidar/odometry factors only couple nodes within the
window (|i - j| <= w, reference BuildOptimizationOverWindow
solver.cc:321-333), so H is block-banded with 3x3 blocks and block
half-bandwidth w.  This module factors and solves the damped system
directly in band form:

- memory O(N w) instead of O(N^2): the dense-H wall (~3 live (3N)^2 f32
  copies) disappears — 100k+ pose graphs fit easily;
- the LM while-loop carry shrinks from a [3N, 3N] dense H (whose
  per-iteration copies dominated an earlier profile) to [w+1, N, 3, 3]
  band blocks;
- factorization work drops from O(N^3) dense Cholesky to O(N s^2) block
  tridiagonal Cholesky.

HITL free line poses (reference data_structures.h:46) couple a handful
of extra dofs to arbitrary nodes, which would break the band; they are
handled as a dense border via the Schur complement on the (tiny) line
block — algebraically identical to solving the full dense system.

Representation
--------------
BandedSystem:
  diag  [N, 3, 3]     block (i, i)
  band  [w, N, 3, 3]  band[d-1][i] = block (i, i-d), zero where i < d
  g     [N, 3]        gradient on node dofs
  C     [N, L, 3, 3]  node-line coupling blocks (border), or L = 0
  E     [L, 3, 3]     line-line diagonal blocks (factors touch one line)
  gl    [L, 3]        gradient on line dofs

Factorization: group s >= w block rows into superblocks of S = 3s dofs;
the superblock matrix is block tridiagonal (diagonal A_k, sub-diagonal
B_k), factored by a lax.scan of Cholesky + triangular solves:

  L_0 L_0^T = A_0;   C_k = B_k L_{k-1}^{-T};   L_k L_k^T = A_k - C_k C_k^T

followed by forward/backward substitution scans.  All per-step ops are
small dense matmuls/factorizations — no scatters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

HIGHEST = jax.lax.Precision.HIGHEST


class BandedSystem(NamedTuple):
    diag: jnp.ndarray            # [N, 3, 3]
    band: jnp.ndarray            # [w, N, 3, 3]
    g: jnp.ndarray               # [N, 3]
    C: Optional[jnp.ndarray]     # [N, L, 3, 3] or None
    E: Optional[jnp.ndarray]     # [L, 3, 3] or None
    gl: Optional[jnp.ndarray]    # [L, 3] or None
    # Low-rank out-of-band block: long-range loop-closure factors whose
    # Gauss-Newton contribution is H_lr = U U^T (U holds each factor's
    # J^T columns).  Solved by the Woodbury identity against the band
    # factorization, so applied loop closures do NOT break the O(N w)
    # band path (solve_damped_banded).
    U: Optional[jnp.ndarray] = None   # [3N, R] or None

    @property
    def n(self):
        return self.diag.shape[0]

    @property
    def w(self):
        return self.band.shape[0]

    @property
    def num_lines(self):
        return 0 if self.C is None else self.C.shape[1]

    @property
    def rank_lr(self):
        return 0 if self.U is None else self.U.shape[1]


def band_matvec(sys: BandedSystem, v, vl=None):
    """H @ [v; vl] in band(+border, +low-rank) form.  v [N, 3]
    (+ vl [L, 3]) -> same shapes."""
    out = jnp.einsum("nij,nj->ni", sys.diag, v, precision=HIGHEST)
    w = sys.w
    for d in range(1, w + 1):
        b = sys.band[d - 1]                      # block (i, i-d) at row i
        # lower: out[i] += b[i] @ v[i-d]
        vd = jnp.pad(v[:-d], ((d, 0), (0, 0)))
        out = out + jnp.einsum("nij,nj->ni", b, vd, precision=HIGHEST)
        # upper: out[i-d] += b[i]^T @ v[i]
        up = jnp.einsum("nji,nj->ni", b, v, precision=HIGHEST)
        out = out + jnp.pad(up[d:], ((0, d), (0, 0)))
    if sys.rank_lr:
        n = sys.n
        uv = jnp.matmul(sys.U.T, v.reshape(3 * n), precision=HIGHEST)
        out = out + jnp.matmul(sys.U, uv, precision=HIGHEST).reshape(n, 3)
    if sys.num_lines and vl is not None:
        out = out + jnp.einsum("nlij,lj->ni", sys.C, vl, precision=HIGHEST)
        outl = (jnp.einsum("nlij,ni->lj", sys.C, v, precision=HIGHEST)
                + jnp.einsum("lij,lj->li", sys.E, vl, precision=HIGHEST))
        return out, outl
    return out, None


def _apply_gauge_band(sys: BandedSystem, fixed):
    """Zero fixed rows/cols with unit diagonal (lm._apply_gauge in band
    form).  fixed: [3N + 3L] bool."""
    n, w = sys.n, sys.w
    fr = fixed[:3 * n].reshape(n, 3)
    keep = (~fr).astype(sys.diag.dtype)
    diag = sys.diag * keep[:, :, None] * keep[:, None, :]
    diag = diag + jax.vmap(jnp.diag)(fr.astype(sys.diag.dtype))
    band = []
    for d in range(1, w + 1):
        kj = jnp.pad(keep[:-d], ((d, 0), (0, 0)), constant_values=0.0)
        band.append(sys.band[d - 1] * keep[:, :, None] * kj[:, None, :])
    band = jnp.stack(band) if band else sys.band
    g = sys.g * keep
    C, E, gl = sys.C, sys.E, sys.gl
    if sys.num_lines:
        L = sys.num_lines
        fl = fixed[3 * n:3 * (n + L)].reshape(L, 3)
        keepl = (~fl).astype(diag.dtype)
        C = C * keep[:, None, :, None] * keepl[None, :, None, :]
        E = E * keepl[:, :, None] * keepl[:, None, :]
        E = E + jax.vmap(jnp.diag)(fl.astype(diag.dtype))
        gl = gl * keepl
    U = sys.U
    if sys.rank_lr:
        # Zeroing fixed ROWS of U zeroes both rows and columns of U U^T.
        U = U * keep.reshape(3 * n)[:, None]
    return BandedSystem(diag, band, g, C, E, gl, U)


def _superblock_tridiag(sys: BandedSystem, s: int):
    """Assemble superblock tridiagonal (A [K, S, S], B [K, S, S]) from the
    band, S = 3 s, K = ceil(n / s).  Pure broadcast/pad ops, no scatter.

    A_k = H[k*S:(k+1)*S, k*S:(k+1)*S]; B_k = H[k*S:(k+1)*S, (k-1)*S:k*S]
    (B_0 = 0).  Requires s >= w so the band never spans more than one
    superblock boundary.
    """
    n, w = sys.n, sys.w
    assert s >= w, (s, w)
    K = -(-n // s)
    pad_n = K * s - n
    dtype = sys.diag.dtype

    def padn(x):
        return jnp.pad(x, ((0, pad_n),) + ((0, 0),) * (x.ndim - 1))

    diag = padn(sys.diag)
    # Padded tail rows get unit diagonal so the factorization stays SPD.
    if pad_n:
        eye_tail = (jnp.arange(K * s) >= n).astype(dtype)
        diag = diag + eye_tail[:, None, None] * jnp.eye(3, dtype=dtype)

    # Lower triangle of A and all of B from band levels; k indexes
    # superblocks, a/b index block rows/cols within a superblock.
    A = jnp.zeros((K, s, s, 3, 3), dtype)
    B = jnp.zeros((K, s, s, 3, 3), dtype)
    ar = jnp.arange(s)
    # Halved diagonal: A_full = A_low + A_low^T below.
    A = A + (0.5 * diag).reshape(K, s, 3, 3)[:, :, None] \
        * jnp.eye(s, dtype=dtype)[None, :, :, None, None]
    for d in range(1, w + 1):
        lvl = padn(sys.band[d - 1]).reshape(K, s, 3, 3)   # block (i, i-d)@i
        in_a = (ar[:, None] - ar[None, :] == d).astype(dtype)   # a - b == d
        A = A + lvl[:, :, None] * in_a[None, :, :, None, None]
        in_b = (s + ar[:, None] - ar[None, :] == d).astype(dtype)
        B = B + lvl[:, :, None] * in_b[None, :, :, None, None]
    A = A + jnp.einsum("kabij->kbaji", A)
    S = 3 * s
    A = A.transpose(0, 1, 3, 2, 4).reshape(K, S, S)
    B = B.transpose(0, 1, 3, 2, 4).reshape(K, S, S)
    return A, B, K, pad_n


def _tridiag_cholesky(A, B):
    """Factor the superblock tridiagonal: returns (Ls [K, S, S] diagonal
    Cholesky factors, Cs [K, S, S] sub-diagonal factors, C_0 = 0)."""
    S = A.shape[1]
    eyeS = jnp.eye(S, dtype=A.dtype)

    def step(L_prev, ab):
        a, b = ab
        # C_k = B_k L_{k-1}^{-T}  ==  (L_{k-1}^{-1} B_k^T)^T
        c = jsl.solve_triangular(L_prev, b.T, lower=True).T
        l = jnp.linalg.cholesky(a - jnp.matmul(c, c.T, precision=HIGHEST))
        return l, (l, c)

    # k = 0 has B_0 = 0 -> C_0 = 0 regardless of the identity init carry.
    _, (Ls, Cs) = jax.lax.scan(step, eyeS, (A, B))
    return Ls, Cs


def _tridiag_solve(Ls, Cs, r):
    """Solve (L L^T) x = r given the tridiagonal factors.  r [K, S, m]."""
    S = Ls.shape[1]
    m = r.shape[-1]

    def fwd(y_prev, lcr):
        l, c, rk = lcr
        y = jsl.solve_triangular(
            l, rk - jnp.matmul(c, y_prev, precision=HIGHEST), lower=True)
        return y, y

    y0 = jnp.zeros((S, m), r.dtype)
    _, ys = jax.lax.scan(fwd, y0, (Ls, Cs, r))

    # Backward: x_k = L_k^{-T} (y_k - C_{k+1}^T x_{k+1})
    Cs_next = jnp.concatenate([Cs[1:], jnp.zeros_like(Cs[:1])])

    def bwd(x_next, lcy):
        l, c_next, yk = lcy
        x = jsl.solve_triangular(
            l.T, yk - jnp.matmul(c_next.T, x_next, precision=HIGHEST),
            lower=False)
        return x, x

    _, xs = jax.lax.scan(bwd, y0, (Ls, Cs_next, ys), reverse=True)
    return xs


class BandFactorization(NamedTuple):
    Ls: jnp.ndarray
    Cs: jnp.ndarray
    K: int
    pad_n: int
    s: int


# ---------------------------------------------------------------------------
# Cyclic reduction: a log-depth alternative to the sequential scan
# factorization.  The scan costs O(K) dependent steps (the dominant device
# cost of the LM loop once assembly went scatter-free); CR eliminates the
# odd superblocks level by level — ceil(log2 K) batched stages of small
# Cholesky/matmul work — at ~2x the FLOPs.
# ---------------------------------------------------------------------------

class CRLevel(NamedTuple):
    """One elimination level.  Block-row convention: row i holds
    B_i x_{i-1} + A_i x_i + B_{i+1}^T x_{i+1} = r_i (B_0 = B_K = 0);
    'odd' = rows 1, 3, ... of this level, Ko = k/2 of them."""

    cho_odd: jnp.ndarray    # [Ko, S, S] Cholesky of A_{2i+1}
    B_ev: jnp.ndarray       # [Ko, S, S] B_{2i}   (even-row left coupling)
    B_od: jnp.ndarray       # [Ko, S, S] B_{2i+1} (odd-row  left coupling)
    AiB_od: jnp.ndarray     # [Ko, S, S] A_{2i+1}^{-1} B_{2i+1}
    AiBevT: jnp.ndarray     # [Ko, S, S] A_{2i+1}^{-1} B_{2i+2}^T


class CRFactorization(NamedTuple):
    levels: tuple           # of CRLevel, finest first
    cho_root: jnp.ndarray   # [1, S, S]
    K: int
    pad_n: int
    s: int


def _cho_batch(A):
    return jnp.linalg.cholesky(A)


def _cho_solve_batch(L, b):
    """Solve (L L^T) x = b for batched L [K, S, S], b [K, S, m]."""
    y = jsl.solve_triangular(L, b, lower=True)
    return jsl.solve_triangular(jnp.swapaxes(L, -1, -2), y, lower=False)


def cr_factor_tridiag(A, B) -> CRFactorization:
    """Factor the superblock tridiagonal by block cyclic reduction.

    A [K, S, S] diagonals, B [K, S, S] sub-diagonals (B_0 = 0); K is
    padded to a power of two with identity diagonals (decoupled rows).
    Each level eliminates the odd rows, yielding the half-size
    tridiagonal over even rows:

      A'_i = A_{2i} - B_{2i} A_{2i-1}^{-1} B_{2i}^T
                    - B_{2i+1}^T A_{2i+1}^{-1} B_{2i+1}
      B'_i = -B_{2i} A_{2i-1}^{-1} B_{2i-1}

    ceil(log2 K) batched stages instead of the scan's K dependent steps.
    """
    K0, S = A.shape[0], A.shape[1]
    K = 1
    while K < K0:
        K *= 2
    if K != K0:
        eye = jnp.broadcast_to(jnp.eye(S, dtype=A.dtype), (K - K0, S, S))
        A = jnp.concatenate([A, eye])
        B = jnp.concatenate([B, jnp.zeros((K - K0, S, S), A.dtype)])
    levels = []
    while A.shape[0] > 1:
        zS = jnp.zeros((1, S, S), A.dtype)
        A_odd = A[1::2]
        cho_odd = _cho_batch(A_odd)
        B_ev = B[0::2]                                     # B_{2i}
        B_od = B[1::2]                                     # B_{2i+1}
        B_next = jnp.concatenate([B[2::2], zS])            # B_{2i+2}
        AiB_od = _cho_solve_batch(cho_odd, B_od)
        AiBevT = _cho_solve_batch(cho_odd,
                                  jnp.swapaxes(B_next, -1, -2))
        levels.append(CRLevel(cho_odd, B_ev, B_od, AiB_od, AiBevT))

        A_ev = A[0::2]
        # Right correction of even row 2i: B_{2i+1}^T A_{2i+1}^{-1} B_{2i+1}.
        corr_r = jnp.matmul(jnp.swapaxes(B_od, -1, -2), AiB_od,
                            precision=HIGHEST)
        # Left correction: B_{2i} A_{2i-1}^{-1} B_{2i}^T (odd row i-1).
        AiBevT_prev = jnp.concatenate(
            [zS, _cho_solve_batch(cho_odd[:-1],
                                  jnp.swapaxes(B_ev[1:], -1, -2))])
        corr_l = jnp.matmul(B_ev, AiBevT_prev, precision=HIGHEST)
        A_new = A_ev - corr_l - corr_r
        # New sub-diagonal: B'_i = -B_{2i} A_{2i-1}^{-1} B_{2i-1}.
        AiB_prev = jnp.concatenate(
            [zS, _cho_solve_batch(cho_odd[:-1], B_od[:-1])])
        B_new = -jnp.matmul(B_ev, AiB_prev, precision=HIGHEST)
        A, B = A_new, B_new
    return CRFactorization(tuple(levels), _cho_batch(A), K, 0, S // 3)


def cr_solve_tridiag(fac: CRFactorization, r):
    """Solve with a cr_factor_tridiag factorization.  r [K0, S, m]."""
    S = fac.cho_root.shape[1]
    K0 = r.shape[0]
    m = r.shape[-1]
    if fac.K != K0:
        r = jnp.concatenate([r, jnp.zeros((fac.K - K0, S, m), r.dtype)])
    # Forward: reduce the RHS level by level.
    # r'_i = r_{2i} - B_{2i} A_{2i-1}^{-1} r_{2i-1}
    #              - B_{2i+1}^T A_{2i+1}^{-1} r_{2i+1}
    stack = []
    for lvl in fac.levels:
        zSm = jnp.zeros((1, S, m), r.dtype)
        z = _cho_solve_batch(lvl.cho_odd, r[1::2])         # A_odd^{-1} r_odd
        stack.append(z)
        z_prev = jnp.concatenate([zSm, z[:-1]])
        r = r[0::2] \
            - jnp.matmul(lvl.B_ev, z_prev, precision=HIGHEST) \
            - jnp.matmul(jnp.swapaxes(lvl.B_od, -1, -2), z,
                         precision=HIGHEST)
    x = _cho_solve_batch(fac.cho_root, r)                   # [1, S, m]
    # Backward: x_{2i+1} = A_{2i+1}^{-1} (r_{2i+1} - B_{2i+1} x_{2i}
    #                                     - B_{2i+2}^T x_{2i+2})
    #                    = z_i - AiB_od x_{2i} - AiBevT x_{2i+2}
    for lvl, z in zip(reversed(fac.levels), reversed(stack)):
        zSm = jnp.zeros((1, S, m), r.dtype)
        x_right = jnp.concatenate([x[1:], zSm])
        x_odd = z \
            - jnp.matmul(lvl.AiB_od, x, precision=HIGHEST) \
            - jnp.matmul(lvl.AiBevT, x_right, precision=HIGHEST)
        k2 = x.shape[0] * 2
        merged = jnp.zeros((k2, S, m), r.dtype)
        merged = merged.at[0::2].set(x)
        merged = merged.at[1::2].set(x_odd)
        x = merged
    return x[:K0]


# Below this node count the sequential scan backend is used; above it,
# block cyclic reduction's log-depth factorization.  The crossover was
# measured on an earlier accelerator and has not been measured on the H100
# yet: the band-scan question of ROADMAP.md section 1 (core solve layers)
# re-decides it.
CR_MIN_NODES = 2000


def resolve_band_plan(n: int, w: int, superblock=None, method: str = "auto"):
    """Resolve (superblock, method) for the block-tridiagonal backend.

    method='auto' picks cyclic reduction at large N (see CR_MIN_NODES)
    and the sequential scan below; superblock=None picks the measured
    best size per backend (CR is fastest at the smallest superblock —
    log-depth makes more, smaller levels cheap — while the scan is flat
    in s and 16 keeps its program small).  Explicit values pass through.
    """
    if method == "auto":
        method = "cr" if n >= CR_MIN_NODES else "scan"
    if superblock is None:
        superblock = 8 if method == "cr" else 16
    return max(superblock, w), method


def band_factor(sys: BandedSystem, s: int,
                method: str = "scan") -> BandFactorization:
    A, B, K, pad_n = _superblock_tridiag(sys, s)
    if method == "cr":
        fac = cr_factor_tridiag(A, B)
        return fac._replace(pad_n=pad_n, s=s)
    Ls, Cs = _tridiag_cholesky(A, B)
    return BandFactorization(Ls, Cs, K, pad_n, s)


def band_apply_inverse(fac, r):
    """Hb^{-1} r for r [N, 3, m] (multi-RHS) or [N, 3] -> same shape."""
    squeeze = r.ndim == 2
    if squeeze:
        r = r[..., None]
    n = r.shape[0]
    m = r.shape[-1]
    K_blocks = -(-n // fac.s)
    rk = jnp.pad(r, ((0, K_blocks * fac.s - n), (0, 0), (0, 0)))
    rk = rk.reshape(K_blocks, fac.s * 3, m)
    if isinstance(fac, CRFactorization):
        x = cr_solve_tridiag(fac, rk)
    else:
        x = _tridiag_solve(fac.Ls, fac.Cs, rk)
    x = x.reshape(K_blocks * fac.s, 3, m)[:n]
    return x[..., 0] if squeeze else x


def _make_node_inverse(sysg: BandedSystem, fac):
    """Closure computing (Hb + U U^T)^{-1} z for z [N, 3, m] or [N, 3]:
    the band factorization plus (when the system carries a low-rank
    loop-closure block U) the Woodbury correction."""
    n, R = sysg.n, sysg.rank_lr
    if not R:
        return lambda z: band_apply_inverse(fac, z)
    T = band_apply_inverse(fac, sysg.U.reshape(n, 3, R))      # Hb^-1 U
    Tf = T.reshape(3 * n, R)
    MW = jsl.cho_factor(
        jnp.eye(R, dtype=Tf.dtype)
        + jnp.matmul(sysg.U.T, Tf, precision=HIGHEST))

    def node_inverse(z):
        z1 = band_apply_inverse(fac, z)
        flat = z1.reshape(3 * n, -1)
        corr = jnp.matmul(Tf, jsl.cho_solve(
            MW, jnp.matmul(sysg.U.T, flat, precision=HIGHEST)),
            precision=HIGHEST)
        return z1 - corr.reshape(z1.shape)

    return node_inverse


def band_inverse_node_columns(sys: BandedSystem, fixed, cols,
                              reg: float = 1e-8, superblock=None,
                              method: str = "auto"):
    """Node-block columns of H^{-1}: returns [3N, m] = (H^{-1})[:3N, cols].

    cols: [m] int32 node-dof indices (< 3N).  The covariance engine of
    the loop-closure matcher (the ceres::Covariance role,
    reference lc_matcher.cc:28-46) in O(N w) memory: gauge by ``fixed``
    (unit rows/cols), Tikhonov-regularize like the dense path, factor the
    band once, and apply the inverse to all requested unit columns in one
    multi-RHS solve.  The HITL border enters via the block-inverse
    identity (H^{-1})_nn = Hn^{-1} + Y S^{-1} Y^T with Y = Hn^{-1} C,
    S = E - C^T Hn^{-1} C; long-range loop-closure factors via the
    Woodbury term exactly as in solve_damped_banded.
    """
    sysg = _apply_gauge_band(sys, fixed)
    n = sysg.n
    # Tikhonov guard (matches matcher._gauged_cholesky's 1e-8 eye).
    diag = sysg.diag + reg * jnp.eye(3, dtype=sysg.diag.dtype)
    sysg = sysg._replace(diag=diag)
    s, method = resolve_band_plan(n, sysg.w, superblock, method)
    fac = band_factor(sysg, s, method)
    node_inverse = _make_node_inverse(sysg, fac)
    m = cols.shape[0]
    rhs = (jnp.arange(3 * n)[:, None] == cols[None, :]).astype(
        sysg.diag.dtype).reshape(n, 3, m)
    X = node_inverse(rhs)                                     # [N, 3, m]
    L = sysg.num_lines
    if L:
        El = sysg.E + reg * jnp.eye(3, dtype=diag.dtype)
        E_dense = jsl.block_diag(*[El[i] for i in range(L)])
        C2 = sysg.C.transpose(0, 2, 1, 3).reshape(n, 3, 3 * L)
        Y = node_inverse(C2)                                  # Hn^-1 C
        CtY = jnp.einsum("nim,nik->mk", C2, Y, precision=HIGHEST)
        S_schur = E_dense - CtY
        CtX = jnp.einsum("nim,nik->mk", C2, X, precision=HIGHEST)  # [3L, m]
        corr = jsl.cho_solve(jsl.cho_factor(S_schur), CtX)
        X = X + jnp.einsum("nim,mk->nik", Y, corr, precision=HIGHEST)
    return X.reshape(3 * n, m)


def solve_damped_banded(sys: BandedSystem, fixed, radius, params,
                        superblock=None, method: str = "auto"):
    """Solve (H + D/radius) dx = -g in band(+border, +low-rank) form.

    Mirrors lm._solve_damped: LM-scaled damping on the clipped diagonal
    of the FULL H (band + low-rank contributions), gauge by fixed-dof
    masking, non-PD surfaces as NaNs (rejected step).  Long-range
    loop-closure factors (H_lr = U U^T) are folded in by the Woodbury
    identity against the band factorization:

        (Hb + U U^T)^{-1} z = Hb^{-1} z - T (I + U^T T)^{-1} U^T Hb^{-1} z,
        T = Hb^{-1} U

    so loop closures cost 3 extra RHS per factor instead of forcing the
    O(N^2) dense path.  Returns (dx [N,3], dxl [L,3] or None, gauged
    system).
    """
    sysg = _apply_gauge_band(sys, fixed)
    n = sysg.n
    R = sysg.rank_lr
    # Damping: d = clip(diag(H_full)); fixed dofs keep their unit diagonal.
    diag_full = jax.vmap(jnp.diag)(sysg.diag)
    if R:
        diag_full = diag_full + jnp.sum(sysg.U * sysg.U,
                                        axis=1).reshape(n, 3)
    dvec = jnp.clip(diag_full, params.min_diagonal, params.max_diagonal)
    fr = fixed[:3 * n].reshape(n, 3)
    dvec = jnp.where(fr, 0.0, dvec)
    diag = sysg.diag + jax.vmap(jnp.diag)(dvec / radius)
    dsys = sysg._replace(diag=diag)

    s, method = resolve_band_plan(n, sysg.w, superblock, method)
    fac = band_factor(dsys, s, method)
    node_inverse = _make_node_inverse(dsys._replace(U=sysg.U), fac)

    L = sysg.num_lines
    if not L:
        dx = node_inverse(-sysg.g)
        return dx, None, sysg

    # Bordered solve via Schur complement on the line block.
    El = sysg.E
    dl_damp = jnp.clip(jax.vmap(jnp.diag)(El),
                       params.min_diagonal, params.max_diagonal)
    fl = fixed[3 * n:3 * (n + L)].reshape(L, 3)
    dl_damp = jnp.where(fl, 0.0, dl_damp)
    El = El + jax.vmap(jnp.diag)(dl_damp / radius)
    E_dense = jsl.block_diag(*[El[i] for i in range(L)])

    C2 = sysg.C.transpose(0, 2, 1, 3).reshape(n, 3, 3 * L)   # [N, 3, 3L]
    rhs = jnp.concatenate([C2, -sysg.g[..., None]], axis=-1)
    sol = node_inverse(rhs)                                   # [N, 3, 3L+1]
    Y, u = sol[..., :3 * L], sol[..., 3 * L]                  # Hn^-1 C, -Hn^-1 g
    CtY = jnp.einsum("nim,nik->mk", C2, Y, precision=HIGHEST)
    Ctu = jnp.einsum("nim,ni->m", C2, u, precision=HIGHEST)
    S_schur = E_dense - CtY
    rl = -sysg.gl.reshape(3 * L) - Ctu
    cf = jsl.cho_factor(S_schur)
    dxl = jsl.cho_solve(cf, rl)
    dx = u - jnp.einsum("nim,m->ni", Y, dxl, precision=HIGHEST)
    return dx, dxl.reshape(L, 3), sysg

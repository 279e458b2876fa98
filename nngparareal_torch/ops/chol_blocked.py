"""Blocked Cholesky in IEEE float32 for the f32 scoring of large Grams.

Port of ``nngparareal_tpu/ops/chol_blocked.py``. ``GParareal`` with
``score_dtype=torch.float32`` ranks its hyperparameter candidates by an f32
NLL; above 48 rows ``ops.gp.gp_nll`` factors the Gram here. The JAX
package wrote this factorisation because the TPU's native f32 Cholesky
runs its inner products in bf16; its contract is that every product is a
true f32 one. On a card, an f32 matrix product may run in TF32 (about ten
mantissa bits) when the process allows it, so every product here runs
with the float32 matmul precision set to "highest" (IEEE f32) for its
duration, whatever the caller set.

Algorithm, as in the JAX package: blocks of ``bs`` columns; each diagonal
block factored by a rank-1 right-looking recurrence, inverted by forward
substitution, and the panel below it solved with that inverse; the
forward substitution for z runs block by block alongside. A non-positive
pivot gives NaN, which propagates (the GP NLL maps it to +inf). The
leading axes of ``Kj`` and ``ym`` are a batch.
"""

import contextlib

import torch


@contextlib.contextmanager
def ieee_f32_matmul():
    """Run float32 matrix products in IEEE f32 (no TF32) inside."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _diag_block_chol(G):
    """Cholesky of (..., bs, bs) blocks by the rank-1 recurrence: pivot
    i is sqrt(G[i, i]), its column G[:, i] / pivot below it, and G loses
    the column's outer product."""
    bs = G.shape[-1]
    rows = torch.arange(bs, device=G.device)
    L = torch.zeros_like(G)
    for i in range(bs):
        piv = torch.sqrt(G[..., i, i])
        col = torch.where(rows > i, G[..., :, i] / piv[..., None], 0.0)
        col[..., i] = piv
        L[..., :, i] = col
        G = G - col[..., :, None] * col[..., None, :]
    return L


def _tri_inv_lower(L):
    """inv(L) of (..., bs, bs) lower-triangular blocks, row by row:
    X[i] = (e_i - L[i, :i] @ X[:i]) / L[i, i]."""
    bs = L.shape[-1]
    cols = torch.arange(bs, device=L.device)
    eye = torch.eye(bs, dtype=L.dtype, device=L.device)
    X = torch.zeros_like(L)
    for i in range(bs):
        li = torch.where(cols < i, L[..., i, :], 0.0)
        row = (eye[i] - (li[..., None, :] @ X)[..., 0, :]) / L[..., i, i, None]
        X[..., i, :] = row
    return X


def chol_diag_solve(Kj, ym, bs=256):
    """(diag(L), z) with L = chol(Kj) lower and L z = ym.

    Kj (..., M, M) already carries its jitter and mask (ops.gp); M is
    padded to a multiple of ``bs`` with an identity block, which gives 1 on
    the diagonal and 0 in z. Returns diag(L) and z of the padded size.
    """
    with ieee_f32_matmul():
        return _chol_diag_solve(Kj, ym, bs)


def _chol_diag_solve(Kj, ym, bs):
    M = Kj.shape[-1]
    bs = min(bs, M)
    pad = (-M) % bs
    batch = Kj.shape[:-2]
    if pad:
        Kp = torch.zeros(batch + (M + pad, M + pad), dtype=Kj.dtype,
                         device=Kj.device)
        Kp[..., :M, :M] = Kj
        idx = torch.arange(M, M + pad, device=Kj.device)
        Kp[..., idx, idx] = 1.0
        Kj = Kp
        ym = torch.cat([ym, ym.new_zeros(ym.shape[:-1] + (pad,))], dim=-1)
        M = M + pad
    L = torch.zeros_like(Kj)
    z = torch.zeros(torch.broadcast_shapes(batch, ym.shape[:-1]) + (M,),
                    dtype=Kj.dtype, device=Kj.device)
    ridx = torch.arange(M, device=Kj.device)
    for r0 in range(0, M, bs):
        r1 = r0 + bs
        cmask = (ridx < r0).to(Kj.dtype)
        Lm = L * cmask  # the columns computed so far
        rowpan = Lm[..., r0:r1, :]  # (..., bs, M)
        G = Kj[..., r0:r1, r0:r1] - rowpan @ rowpan.transpose(-1, -2)
        Ljj = _diag_block_chol(G)
        inv = _tri_inv_lower(Ljj)
        T = Kj[..., :, r0:r1] - Lm @ rowpan.transpose(-1, -2)
        X = (T @ inv.transpose(-1, -2)) * (ridx >= r1).to(Kj.dtype)[:, None]
        X[..., r0:r1, :] = Ljj
        L[..., :, r0:r1] = X
        rhs = ym[..., r0:r1] - (rowpan @ (z * cmask)[..., None])[..., 0]
        z[..., r0:r1] = (inv @ rhs[..., None])[..., 0]
    return torch.diagonal(L, dim1=-2, dim2=-1), z

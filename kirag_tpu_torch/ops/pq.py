"""Product quantization (PQ) of corpus rows (port of :mod:`kirag_tpu.ops.pq`),
the answer to FAISS ``IndexPQ(n_subquantizers, n_bits)``.

The index format is the reference's, so a PQ index written by either
package loads in the other with the same codes:

- **Strided subspaces.** Subspace ``s`` of ``m`` owns the dims
  ``{j * m + s : j < ds}``, ``ds = D / m``; component ``j`` of every
  subspace is the contiguous column block ``[j * m, (j + 1) * m)``.
- **4-bit codes** (K = 16 centroids a subspace), two a byte: byte ``t`` of a
  row holds subspace ``t`` in its low nibble and subspace ``t + m / 2`` in
  its high one, so a row is ``m / 2`` bytes (32x smaller than float32 at
  D = 1024, m = 256). A FAISS request for more bits a code maps to twice the
  subquantizers at 4 bits (:func:`resolve_subquantizers`).
- **The level table** ``L [16, D]``, ``L[t, j * m + s] = codebooks[s, t, j]``
  (:func:`pq_level_table`), is what the exact-search kernels score codes
  through (K4's ``pq4`` format, :func:`~kirag_tpu_torch.kernels.exact.quant_scores`).

Training is Lloyd k-means in every subspace at once, on the sample's device,
in float32 (never TF32: it would round the assignment scores and move their
ties): assignment by the largest ``x.c - 0.5 ||c||^2``, ties to the lower
centroid; an empty cluster keeps its centroid; the codebooks are snapped to
bfloat16-representable values at the end, as the reference does. The 16
initial rows are the reference's: ``jax.random.choice(jax.random.key(seed),
N, (16,), replace=False)``, restated in numpy
(:mod:`kirag_tpu_torch.utils.jax_random`), so the same sample and seed start
both packages from the same rows. Encoding assigns each row's subspace
vectors the same way, block by block on the rows' device.
"""

from __future__ import annotations

import numpy as np
import torch

from kirag_tpu_torch.utils.jax_random import choice_without_replacement

K = 16          # centroids per subspace (4-bit codes)
NBITS = 4
_SUB_BLOCK = 64  # subspaces trained at a time (bounds the [m, N, K] temporaries)


def subspace_view(x: torch.Tensor, m: int) -> torch.Tensor:
    """[N, D] -> [m, N, ds] under the strided-subspace partition (subspace s
    = dims {j * m + s})."""
    n, d = x.shape
    return x.reshape(n, d // m, m).permute(2, 0, 1)


def _check_geometry(d: int, m: int) -> None:
    if m < 2 or m % 2 != 0 or d % m != 0:
        raise ValueError(f"PQ needs an even subquantizer count dividing dim; got m={m}, "
                         f"dim={d}")


def _check_f32_matmul(x: torch.Tensor) -> None:
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("PQ runs its products in float32: turn "
                           "torch.backends.cuda.matmul.allow_tf32 off")


def _assign(sub: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of every subspace vector: ``sub`` [m, N, ds],
    ``cent`` [m, K, ds] -> [m, N] int64, the argmax of
    ``x.c - 0.5 ||c||^2`` (ties to the lower centroid, as ``torch.argmax``
    and ``jnp.argmax`` take the first maximum)."""
    scores = torch.bmm(sub, cent.transpose(1, 2))
    scores = scores - 0.5 * (cent * cent).sum(-1)[:, None, :]
    return scores.argmax(-1)


def init_rows(n: int, seed: int) -> torch.Tensor:
    """The K distinct sample rows that start k-means, as the reference draws
    them (``jax.random.choice(jax.random.key(seed), n, (K,),
    replace=False)``), on the CPU."""
    return torch.from_numpy(choice_without_replacement(seed, n, K))


def lloyd(sample: torch.Tensor, m: int, init: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Lloyd iterations in every subspace from the sample rows
    ``init`` (K row ids) -> codebooks [m, K, ds] f32, unsnapped, on the
    sample's device. Cluster sums are one-hot products and are divided by a
    tensor of counts (a division rounded once)."""
    n, d = sample.shape
    _check_geometry(d, m)
    _check_f32_matmul(sample)
    out = []
    levels = torch.arange(K, device=sample.device)
    for s0 in range(0, m, _SUB_BLOCK):
        sub = subspace_view(sample.to(torch.float32), m)[s0:s0 + _SUB_BLOCK].contiguous()
        cent = sub[:, init.to(sample.device), :]                       # [mb, K, ds]
        for _ in range(iters):
            onehot = (_assign(sub, cent)[..., None] == levels).to(torch.float32)  # [mb, N, K]
            counts = onehot.sum(1)                                     # [mb, K]
            sums = torch.bmm(onehot.transpose(1, 2), sub)              # [mb, K, ds]
            cent = torch.where(counts[..., None] > 0,
                               sums / counts.clamp_min(1.0)[..., None], cent)
        out.append(cent)
    return torch.cat(out)


def train_pq(sample, m: int, iters: int = 25, seed: int = 0) -> torch.Tensor:
    """Lloyd k-means per subspace -> codebooks [m, K, ds] f32 on the
    sample's device, snapped to bfloat16-representable values (round to
    nearest even), so every scoring path sees the same numbers."""
    sample = torch.as_tensor(sample)
    n, d = sample.shape
    _check_geometry(d, m)
    if n < K:
        raise ValueError(f"need at least {K} training rows, got {n}")
    cent = lloyd(sample, m, init_rows(n, seed), iters)
    return cent.to(torch.bfloat16).to(torch.float32)


def encode_pq(x: torch.Tensor, codebooks: torch.Tensor, batch: int = 65536) -> torch.Tensor:
    """Packed codes [N, m/2] uint8 of the rows ``x`` [N, D] on their device:
    each subspace vector's nearest centroid (:func:`lloyd`'s assignment),
    byte t = code(subspace t) | code(subspace t + m/2) << 4."""
    m = codebooks.shape[0]
    _check_geometry(x.shape[1], m)
    _check_f32_matmul(x)
    cb = codebooks.to(device=x.device, dtype=torch.float32)
    out = torch.empty((x.shape[0], m // 2), dtype=torch.uint8, device=x.device)
    for start in range(0, x.shape[0], batch):
        rows = x[start:start + batch].to(torch.float32)
        code = _assign(subspace_view(rows, m), cb).to(torch.uint8)   # [m, B]
        out[start:start + len(rows)] = (code[:m // 2] | (code[m // 2:] << 4)).T
    return out


def pq_level_table(codebooks: np.ndarray) -> np.ndarray:
    """Codebooks [m, K, ds] -> the kernels' level table L [K, D]:
    ``L[t, j*m + s] = codebooks[s, t, j]``."""
    m, k, ds = codebooks.shape
    assert k == K
    return np.ascontiguousarray(
        np.transpose(codebooks, (1, 2, 0)).reshape(K, ds * m)).astype(np.float32)


def decode_pq(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Numpy reconstruction oracle: packed [N, m/2] codes -> [N, D] f32."""
    m, k, ds = codebooks.shape
    lo = (codes & 0xF).astype(np.int64).T                  # [m/2, N]
    hi = (codes >> 4).astype(np.int64).T
    code = np.concatenate([lo, hi], axis=0)                # [m, N]
    sub = codebooks[np.arange(m)[:, None], code]           # [m, N, ds]
    return np.ascontiguousarray(sub.transpose(1, 2, 0).reshape(codes.shape[0], ds * m))


def pq_bytes_per_row(d: int, m: int) -> int:
    return m // 2


def resolve_subquantizers(d: int, n_subquantizers: int, n_bits: int) -> int:
    """Map a FAISS ``IndexPQ(n_subquantizers, n_bits)`` request onto 4-bit
    codes: a request for more than 4 bits doubles the subquantizers (equal
    bytes a row); the result is clamped to a legal geometry (even, divides
    d, at most d)."""
    m = n_subquantizers if n_bits <= NBITS else 2 * n_subquantizers
    m = max(2, min(m, d))
    while m > 2 and (d % m != 0 or m % 2 != 0):
        m -= 1
    return m


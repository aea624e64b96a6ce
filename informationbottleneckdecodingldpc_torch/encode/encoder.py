"""Systematic LDPC encoding on the device.

Port of ``encode/encoder.py`` ``LDPCEncoder.device_encoder``. The host
encoder (``LDPCEncoder``: H split as [A | B], triangular test or GF(2)
factorisation, the native C++ substitution) is the JAX package's numpy code
and is reused as it is; only its device path is written here, so the port
never calls the JAX ``device_encoder``. Parity bits solve B p = A u:

- s = A u over GF(2), as an XOR of gathered info bits per check;
- staircase B (accumulator codes such as DVB-S2): p is the prefix XOR of s;
- otherwise, for m = N - K <= 4096: p = B^-1 s with the dense GF(2) inverse
  of B made once on the host. The product runs in float32: its entries are
  0/1 and its sums at most m, all exact, even in TF32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from informationbottleneckdecodingldpc_tpu.encode.encoder import (
    LDPCEncoder,
    _gf2_dense_inverse,
)

DENSE_INVERSE_MAX_CHECKS = 4096


def device_encoder(
    enc: LDPCEncoder, device: torch.device | str
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Carry the host encoder's matrices to ``device``; the returned function
    maps info bits [K, batch] (0/1, any integer type) to int8 codewords
    [N, batch], systematic bits first. Raises when B has no device path."""
    device = torch.device(device)
    k, m = enc.k, enc.n - enc.k
    A = sp.csr_matrix(enc.H[:, :k])
    row_deg = np.diff(A.indptr)
    # Each check's info columns, padded with index K (a row of zeros).
    cols = np.full((m, int(row_deg.max())), k, dtype=np.int64)
    for r in range(m):
        cols[r, : row_deg[r]] = A.indices[A.indptr[r] : A.indptr[r + 1]]
    cols_t = torch.as_tensor(cols.T.copy(), device=device)  # [max_deg, m]

    binv = None
    if not enc.is_staircase:
        if m > DENSE_INVERSE_MAX_CHECKS:
            raise ValueError(
                f"no device encoder for a non-staircase B with {m} checks"
            )
        inv = _gf2_dense_inverse(enc.B.toarray().astype(np.uint8))
        if inv is None:
            raise ValueError("B is singular over GF(2)")
        binv = torch.as_tensor(inv.astype(np.float32), device=device)

    def encode(info: torch.Tensor) -> torch.Tensor:
        u = info.to(torch.int8)
        u_pad = torch.cat([u, u.new_zeros((1, u.shape[1]))])
        s = u_pad[cols_t[0]]
        for c in cols_t[1:]:
            s = s ^ u_pad[c]
        if binv is None:
            # Scanned along the contiguous dimension: torch's scan over the
            # outer one walks each column's m rows in sequence (11.9 ms for
            # DVB-S2 at batch 1024 on an H100).
            scan = torch.cumsum(s.t().contiguous(), dim=1, dtype=torch.int32)
            parity = scan.t() & 1
        else:
            parity = (binv @ s.to(torch.float32)).to(torch.int32) & 1
        return torch.cat([u, parity.to(torch.int8)])

    return encode

"""The plain reference of the Monte-Carlo steps a cell's window drove.

From the same seed, Eb/N0 and step indices it works out again everything
the system under test derives: each step's Philox key and planes, the
quantizer's tables, the transmitted codewords, the decoder's input, the
decode and the counts. It reads the configuration's code and decoder tables
and nothing the program made.

A step of ``batch`` codewords on the BPSK chains:

- ``allzero``: the all-zeros codeword; the decoder's input is sampled by
  inversion from the step's uniform plane (cluster t ~ p(t | x = 0));
- ``encoded``: info bits from the bits plane, encoded systematically, sent
  as BPSK (bit 0 -> +1) with the normal plane's noise, y = (1 - 2c) +
  sqrt(sigma^2) n in float32 with sigma^2 rounded to float32, quantized.

sigma^2 comes from Eb/N0 and the code's design rate 1 - E[d_v] / E[d_c]
(node-perspective degree distributions), the quantizer's tables from the
unrounded sigma^2. Bit errors count the information bits (the first k) of
each codeword; a frame error is a codeword with any.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import scipy.sparse as sp
import torch

from . import code as codes
from . import philox, quantizer


def design_rate(H: sp.csr_matrix) -> float:
    """1 - E[d_v] / E[d_c] over node-perspective degree distributions."""
    H = sp.csr_matrix(H)

    def mean_degree(degrees: np.ndarray) -> float:
        dist = np.bincount(degrees)[1:]
        dist = dist / dist.sum()
        return float(np.dot(dist, np.arange(dist.shape[0]) + 1))

    return 1.0 - mean_degree(H.getnnz(axis=0)) / mean_degree(H.getnnz(axis=1))


class ReferenceChain:
    """The reference of one configuration (its JSON, with the parity-check
    matrix ``H``) on ``device``; ``message_bits`` makes the control."""

    def __init__(self, config: dict, tables_path: str, H: sp.csr_matrix,
                 device: torch.device | str, message_bits: int | None = None):
        self.config = config
        self.device = torch.device(device)
        self.H = sp.csr_matrix(H)
        self.n = self.H.shape[1]
        self.k = self.n - self.H.shape[0]
        self.rate = design_rate(self.H)
        graph = codes.graph(self.H, config["code"])
        kind = config["decoder"]["kind"]
        module = importlib.import_module(f"{__package__}.{kind}_decode")
        self.decoder = module.make(graph, config, tables_path, self.device, message_bits)
        self._encoder = None
        self._tables = {}

    def encoder(self) -> codes.Encoder:
        if self._encoder is None:
            self._encoder = codes.Encoder(self.H, self.device)
        return self._encoder

    def _quantizer(self, ebn0_db: float):
        if ebn0_db not in self._tables:
            self._tables[ebn0_db] = self._build_quantizer(ebn0_db)
        return self._tables[ebn0_db]

    def _build_quantizer(self, ebn0_db: float):
        c = self.config["channel"]
        sigma2 = quantizer.sigma2_from_ebn0_db(ebn0_db, self.rate)
        limits, cdf, llrs = quantizer.tables(sigma2, c["ad_max_abs"], self.decoder.t_channel,
                                             c["cardinality_y"])
        on = lambda a: torch.as_tensor(a, device=self.device)
        return float(np.float32(sigma2)), on(limits), on(cdf), on(llrs)

    def inputs(self, seed: int, ebn0_db: float, step: int, batch: int, chain: str):
        """The decoder's input [n, batch] of one step and its codewords
        (None on the all-zeros chain)."""
        sigma2, limits, cdf, llrs = self._quantizer(ebn0_db)
        key = philox.step_key(seed, ebn0_db, step)
        if chain == "allzero":
            clusters = quantizer.count_below(cdf[1:-1], philox.plane("uniform", key, self.n, 0, batch,
                                                                     self.device))
            codeword = None
        elif chain == "encoded":
            codeword = self.encoder()(philox.plane("bits", key, self.k, 0, batch, self.device))
            noise = philox.plane("normal", key, self.n, 0, batch, self.device)
            y = (1.0 - 2.0 * codeword.to(torch.float32)) + math.sqrt(sigma2) * noise
            clusters = quantizer.count_below(limits[1:], y)
        else:
            raise ValueError(f"unknown chain {chain!r}")
        if self.decoder.consumer == "llrs":
            return llrs[clusters.long()], codeword
        return clusters, codeword

    def steps(self, seed: int, ebn0_db: float, steps: list[int], batch: int, chain: str,
              tile: int, max_columns: int = 2**28) -> list[dict]:
        """Each step's input, codewords, hard decisions [n, batch] (bool),
        per-codeword bit errors and bodies, and its mean bodies as float32.
        Steps are decoded together, each padded to whole tiles of ``tile``
        codewords (padding holds input 0), at most ``max_columns`` view
        elements at a time."""
        pad = -batch % tile
        per_block = max(1, max_columns // ((self.decoder.n_edges + self.n) * (batch + pad)))
        out = []
        for b0 in range(0, len(steps), per_block):
            block = [self.inputs(seed, ebn0_db, s, batch, chain) for s in steps[b0:b0 + per_block]]
            x = torch.cat([torch.nn.functional.pad(i, (0, pad)) for i, _ in block], dim=1)
            decisions, bodies = self.decoder.decode(x, tile)
            for j, (inp, cw) in enumerate(block):
                cols = slice(j * (batch + pad), j * (batch + pad) + batch)
                hard = self.decoder.hard(decisions[:, cols])
                sent = torch.zeros_like(hard) if cw is None else cw.bool()
                errors = (hard[: self.k] != sent[: self.k]).sum(dim=0)
                it = bodies[cols].cpu().numpy()
                out.append(dict(
                    input=inp, codeword=cw, hard=hard, errors=errors.cpu().numpy(),
                    bodies=it, mean_bodies=np.float32(np.float32(it.sum()) * np.float32(1.0 / batch)),
                ))
        return out

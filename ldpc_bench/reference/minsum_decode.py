"""The min-sum decoder of |T|-level channel LLRs, written plainly.

Semantics (the upstream's ``Continous_LDPC_Decoding/min_sum_decoder_irreg.py``
with its OpenCL node rules ``kernels_min_and_BP.cl``, check node
``checknode_update_minsum``, variable node ``varnode_update``):

- the variable-to-check messages start as the channel LLRs of each edge's
  variable;
- a check node sends on edge j the product of the signs of its other
  edges' messages times the least of their magnitudes;
- a variable node sends on edge j its total less the message on edge j,
  clamped to [-150, 150], where the total is the channel LLR plus the
  left-fold sum of its incoming messages in its inbox order (``code.graph``),
  ch + ((m_0 + m_1) + ...); a degree-1 variable sends its clamped channel
  LLR;
- a body is a check pass then a variable pass, at most ``i_max - 1`` bodies;
- the codewords exit in tiles: a tile whose codewords all satisfy every
  check after a body (the hard bit of a variable-to-check message is
  LLR < 0, a check is satisfied when the XOR of its inputs' bits is 0)
  stops after that body, which counts; a codeword's iteration count is the
  bodies its tile ran;
- the decision is the channel LLR plus the left-fold sum of the check
  messages of the last body, unclamped; LLR < 0 decides bit 1.

Departures from the upstream, each as the configuration states it: float32
where the upstream computes in float64; every variable-to-check message
clamped to +-150 (``LLR_MAX`` of the upstream's kernel file, line 3); the
exit per tile after the body whose variable-to-check messages satisfy every
check, counting that body (the port's convention), where the upstream tests
the syndrome of the whole batch on the host.

Min, sign and clamp are exact and the sums are left folds of adds in a
fixed order, so the decoder is reproducible bit for bit. A zero may carry
either sign, depending on the order in which a decoder multiplies signs;
it never reaches a comparison, since :meth:`MinSumDecoder.hard` and the
syndrome decide bit 0 for +0 and -0 alike, and a zero magnitude makes the
same sum with either sign.

``message_bits`` makes the control: every message a node sends is rounded
to that many significant bits of float32 (the implicit bit counted), to
nearest even; 8 is bfloat16's significand.
"""

from __future__ import annotations

import torch

from .code import Graph

LLR_MAX = 150.0
FLOAT32_BITS = 24  # significant bits of a float32, the implicit one counted


def make(graph: Graph, config: dict, tables_path: str | None, device: torch.device,
         message_bits: int | None = None) -> "MinSumDecoder":
    """The decoder a configuration's ``decoder`` states; it reads no tables."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return MinSumDecoder(graph, config["channel"]["cardinality_t"], config["decoder"]["i_max"],
                         device, early_exit=config["decoder"]["early_exit"],
                         message_bits=message_bits)


def round_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Float32 ``x`` rounded to ``bits`` significant bits, to nearest even."""
    drop = FLOAT32_BITS - bits
    i = x.view(torch.int32)
    i = i + ((1 << (drop - 1)) - 1) + ((i >> drop) & 1)
    return (i & -(1 << drop)).view(torch.float32)


def left_sum(planes: torch.Tensor) -> torch.Tensor:
    """((p_0 + p_1) + p_2) + ... over axis 0."""
    total = planes[0]
    for p in planes[1:]:
        total = total + p
    return total


class MinSumDecoder:
    """Plain min-sum decoder of ``graph``, float32 messages on ``device``."""

    consumer = "llrs"  # what it reads of the channel

    def __init__(self, graph: Graph, t_channel: int, i_max: int, device: torch.device | str,
                 early_exit: bool = True, message_bits: int | None = None):
        self.device = device = torch.device(device)
        self.t_channel = t_channel
        self.i_max = i_max
        self.early_exit = early_exit
        self.message_bits = message_bits
        as_i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        self.checks = [(d, as_i(e)) for d, (_, e) in sorted(graph.check_groups.items())]
        self.vars = [(d, as_i(n), as_i(e)) for d, (n, e) in sorted(graph.var_groups.items())]
        self.edge_var = as_i(graph.edge_var)
        self.n_edges = graph.n_edges

    def hard(self, outputs: torch.Tensor) -> torch.Tensor:
        """Hard decisions (True: bit 1) of posterior LLRs."""
        return outputs < 0

    def _send(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.message_bits is None else round_bits(out, self.message_bits)

    def _gather(self, x: torch.Tensor, eids: torch.Tensor, d: int) -> torch.Tensor:
        return x.index_select(0, eids.reshape(-1)).reshape(d, -1, x.shape[1])

    def _check_pass(self, x: torch.Tensor) -> torch.Tensor:
        """Check-to-variable messages [E, B] from variable-to-check ``x``."""
        out = torch.empty_like(x)
        for d, eids in self.checks:
            m = self._gather(x, eids, d)
            mags, negs = m.abs(), (m < 0).to(torch.int32)
            parity = negs.sum(dim=0)
            res = []
            for j in range(d):
                least = torch.cat([mags[:j], mags[j + 1:]]).amin(dim=0)
                res.append(torch.where((parity - negs[j]) % 2 == 1, -least, least))
            out[eids.reshape(-1)] = self._send(torch.stack(res)).reshape(-1, x.shape[1])
        return out

    def _var_pass(self, ch: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Variable-to-check messages [E, B] from check-to-variable ``x``."""
        out = torch.empty_like(x)
        for d, nodes, eids in self.vars:
            c = ch.index_select(0, nodes)
            if d == 1:
                res = c.clamp(-LLR_MAX, LLR_MAX)[None]
            else:
                m = self._gather(x, eids, d)
                total = c + left_sum(m)
                res = (total[None] - m).clamp(-LLR_MAX, LLR_MAX)
            out[eids.reshape(-1)] = self._send(res).reshape(-1, x.shape[1])
        return out

    def _unsatisfied(self, x: torch.Tensor) -> torch.Tensor:
        """Unsatisfied checks per codeword [B] of variable-to-check ``x``."""
        bits = (x < 0).to(torch.int32)
        total = torch.zeros(x.shape[1], dtype=torch.int32, device=x.device)
        for d, eids in self.checks:
            total += (self._gather(bits, eids, d).sum(dim=0) & 1).sum(dim=0, dtype=torch.int32)
        return total

    def _decide(self, ch: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Posterior LLRs [N, B] from check-to-variable ``x``."""
        out = torch.empty_like(ch)
        for d, nodes, eids in self.vars:
            out[nodes] = ch.index_select(0, nodes) + left_sum(self._gather(x, eids, d))
        return out

    def decode(self, llrs: torch.Tensor, tile: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode channel LLRs [N, B] (B a multiple of ``tile``): the
        posterior LLRs [N, B] float32 and each codeword's bodies [B] int32."""
        ch = llrs.to(device=self.device, dtype=torch.float32)
        batch = ch.shape[1]
        if batch % tile:
            raise ValueError(f"batch {batch} is not a multiple of the tile {tile}")
        v2c = ch.index_select(0, self.edge_var)
        c2v = torch.zeros_like(v2c)
        iters = torch.zeros(batch, dtype=torch.int32, device=self.device)
        active = torch.ones(batch // tile, dtype=torch.bool, device=self.device)
        for i in range(self.i_max - 1):
            new = self._check_pass(v2c)
            v2c = self._var_pass(ch, new)
            cols = active.repeat_interleave(tile)
            c2v = torch.where(cols[None, :], new, c2v)
            iters = torch.where(cols, i + 1, iters)
            if self.early_exit:
                active &= ~(self._unsatisfied(v2c).view(-1, tile) == 0).all(dim=1)
                if not bool(active.any()):
                    break
        return self._decide(ch, c2v), iters

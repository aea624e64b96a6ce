"""The discrete Information-Bottleneck lookup-table decoder, written plainly.

Semantics (the decoder a configuration states, Lewandowsky and Bauch's IB
decoding with message alignment):

- every node folds its incoming messages left to right in its inbox order
  (``code.graph``) through pairwise tables, one table per fold step; the
  output on edge j folds all inputs but the one from edge j;
- the first check pass reads the channel clusters with the iteration-0
  tables (step 0 ``cn_iter0_first``, step l >= 1 ``cn_iter0_rest[l - 1]``);
- body i (i = 0 .. i_max - 2): a variable pass (the channel and the
  messages, step 0 ``vn_first[i]``, step p >= 1 ``vn_rest[i][p - 1]``; a
  degree-1 variable sends its channel cluster), then a check pass with
  ``cn_rest[i]``;
- with message alignment every output of a check pass of iteration t (0 for
  the first pass, i + 1 for body i) is remapped by ``matching_cn[t][d - 1]``
  and every output of a variable pass of degree d > 1 by
  ``matching_vn[i][d - 1]``;
- the codewords exit in tiles: after each body a tile whose codewords all
  satisfy every check (the hard bit of a variable-to-check message is
  t < T / 2, a check is satisfied when the XOR of its inputs' bits is 0)
  stops; a codeword's iteration count is the bodies its tile ran;
- the decision folds the channel and all of a variable's messages with the
  variable tables of that count; cluster t < T / 2 decides bit 1.

Messages are int32 on any device, and each lookup is one gather from a
flattened table. ``message_bits`` below log2(T) keeps only that many bits of
every message a node sends (the control: a message alphabet one bit
coarser; label t becomes t with its low bits cleared, so the hard decision
is unchanged).
"""

from __future__ import annotations

import numpy as np
import torch

from .code import Graph

TABLE_KEYS = ("cn_iter0_first", "cn_iter0_rest", "cn_rest", "vn_first", "vn_rest",
              "matching_cn", "matching_vn")


def load_tables(path: str) -> dict:
    """A decoder's tables from its .npz file (numpy arrays and ints)."""
    with np.load(path) as z:
        out = {k: z[k] for k in TABLE_KEYS if k in z}
        for k in ("cardinality_t_channel", "cardinality_t_decoder", "i_max"):
            out[k] = int(z[k])
    return out


class Lut:
    """A [rows, width] table (or a stack of them) flattened on a device."""

    def __init__(self, table: np.ndarray, device: torch.device):
        self.flat = torch.as_tensor(np.ascontiguousarray(table).reshape(-1), dtype=torch.int32,
                                    device=device)
        self.width = int(table.shape[-1])

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.flat.index_select(0, (a * self.width + b).reshape(-1)).reshape(b.shape)


def make(graph: Graph, config: dict, tables_path: str, device: torch.device,
         message_bits: int | None = None) -> "IBDecoder":
    """The decoder a configuration's ``decoder`` states, its tables read
    from ``tables_path``."""
    tables = load_tables(tables_path)
    stated = config["decoder"]
    for key, value in (("t_channel", tables["cardinality_t_channel"]),
                       ("t_decoder", tables["cardinality_t_decoder"]), ("i_max", tables["i_max"])):
        if stated[key] != value:
            raise ValueError(f"the configuration states {key} {stated[key]}, its tables {value}")
    return IBDecoder(graph, tables, device, alignment=stated["message_alignment"],
                     message_bits=message_bits)


class IBDecoder:
    """Plain IB decoder of ``graph`` with ``tables`` (:func:`load_tables`)."""

    consumer = "clusters"  # what it reads of the channel

    def __init__(self, graph: Graph, tables: dict, device: torch.device | str,
                 alignment: bool = True, message_bits: int | None = None):
        self.g = graph
        self.device = device = torch.device(device)
        self.t = tables["cardinality_t_decoder"]
        self.t_channel = tables["cardinality_t_channel"]
        self.i_max = tables["i_max"]
        self.mask = None if message_bits is None else -(1 << (int(np.log2(self.t)) - message_bits))
        tb = tables
        self.cn0 = [Lut(tb["cn_iter0_first"], device)] + [
            Lut(x, device) for x in tb["cn_iter0_rest"]]
        self.cn = [[Lut(x, device) for x in it] for it in tb["cn_rest"]]
        self.vn_first = [Lut(x, device) for x in tb["vn_first"]]
        self.vn_rest = [[Lut(x, device) for x in it] for it in tb["vn_rest"]]
        align = alignment and "matching_cn" in tb
        as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
        self.match_cn = as_t(tb["matching_cn"]) if align else None
        self.match_vn = as_t(tb["matching_vn"]) if align else None
        self.dec_first = as_t(tb["vn_first"]).reshape(-1)
        self.dec_rest = as_t(tb["vn_rest"]).reshape(-1)
        self.d_v_rest = tb["vn_rest"].shape[1]
        as_i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        self.checks = [(d, as_i(e)) for d, (_, e) in sorted(graph.check_groups.items())]
        self.vars = [(d, as_i(n), as_i(e)) for d, (n, e) in sorted(graph.var_groups.items())]
        self.edge_var = as_i(graph.edge_var)
        self.n_edges = graph.n_edges

    def hard(self, outputs: torch.Tensor) -> torch.Tensor:
        """Hard decisions (True: bit 1) of decision clusters."""
        return outputs < self.t // 2

    def _send(self, out: torch.Tensor, row: torch.Tensor | None) -> torch.Tensor:
        if row is not None:
            out = row.index_select(0, out.reshape(-1)).reshape(out.shape)
        return out if self.mask is None else out & self.mask

    def _check_pass(self, x: torch.Tensor, luts: list, match: torch.Tensor | None) -> torch.Tensor:
        """Check-to-variable messages [E, B] from variable-to-check ``x``."""
        out = torch.empty_like(x)
        for d, eids in self.checks:
            m = x.index_select(0, eids.reshape(-1)).reshape(d, -1, x.shape[1])
            if d == 2:
                out[eids.reshape(-1)] = self._send(m.flip(0), None).reshape(-1, x.shape[1])
                continue
            prefix = [None, luts[0](m[0], m[1])]  # prefix[k]: fold of m_0 .. m_k
            for k in range(2, d - 1):
                prefix.append(luts[k - 1](prefix[k - 1], m[k]))
            res = []
            for j in range(d):
                if j >= 2:
                    acc, start = prefix[j - 1], j + 1
                else:
                    acc, start = luts[0](m[1 - j], m[2]), 3
                for k in range(start, d):
                    acc = luts[k - 2](acc, m[k])
                res.append(acc)
            row = None if match is None else match[d - 1]
            out[eids.reshape(-1)] = self._send(torch.stack(res), row).reshape(-1, x.shape[1])
        return out

    def _var_pass(self, ch: torch.Tensor, x: torch.Tensor, i: int) -> torch.Tensor:
        """Variable-to-check messages [E, B] of body ``i`` from check-to-variable ``x``."""
        out = torch.empty_like(x)
        luts = [self.vn_first[i]] + self.vn_rest[i]
        for d, nodes, eids in self.vars:
            c = ch.index_select(0, nodes)
            if d == 1:
                out[eids.reshape(-1)] = c if self.mask is None else c & self.mask
                continue
            m = x.index_select(0, eids.reshape(-1)).reshape(d, -1, x.shape[1])
            prefix = [luts[0](c, m[0])]  # prefix[k]: fold of ch, m_0 .. m_k
            for k in range(1, d - 1):
                prefix.append(luts[k](prefix[k - 1], m[k]))
            res = []
            for j in range(d):
                if j >= 1:
                    acc, start = prefix[j - 1], j + 1
                else:
                    acc, start = luts[0](c, m[1]), 2
                for k in range(start, d):
                    acc = luts[k - 1](acc, m[k])
                res.append(acc)
            row = None if self.match_vn is None else self.match_vn[i][d - 1]
            out[eids.reshape(-1)] = self._send(torch.stack(res), row).reshape(-1, x.shape[1])
        return out

    def _unsatisfied(self, x: torch.Tensor) -> torch.Tensor:
        """Unsatisfied checks per codeword [B] of variable-to-check ``x``."""
        bits = (x < self.t // 2).to(torch.int32)
        total = torch.zeros(x.shape[1], dtype=torch.int32, device=x.device)
        for d, eids in self.checks:
            b = bits.index_select(0, eids.reshape(-1)).reshape(d, -1, x.shape[1])
            total += (b.sum(dim=0) & 1).sum(dim=0, dtype=torch.int32)
        return total

    def _decide(self, ch: torch.Tensor, x: torch.Tensor, iters: torch.Tensor) -> torch.Tensor:
        """Decision clusters [N, B] with each codeword's own iteration tables."""
        out = torch.empty_like(ch)
        it = iters.to(torch.int32)[None, :]
        for d, nodes, eids in self.vars:
            m = x.index_select(0, eids.reshape(-1)).reshape(d, -1, x.shape[1])
            c = ch.index_select(0, nodes)
            take = lambda table, idx: table.index_select(0, idx.reshape(-1)).reshape(c.shape)
            acc = take(self.dec_first, (it * self.t_channel + c) * self.t + m[0])
            for p in range(1, d):
                acc = take(self.dec_rest, ((it * self.d_v_rest + (p - 1)) * self.t + acc) * self.t + m[p])
            out[nodes] = acc
        return out

    def decode(self, clusters: torch.Tensor, tile: int, max_iters: int | None = None,
               early_exit: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode channel clusters [N, B] (B a multiple of ``tile``): the
        decision clusters [N, B] int32 and each codeword's bodies [B] int32."""
        i_max = max_iters or self.i_max
        ch = clusters.to(device=self.device, dtype=torch.int32)
        batch = ch.shape[1]
        if batch % tile:
            raise ValueError(f"batch {batch} is not a multiple of the tile {tile}")
        match = lambda t: None if self.match_cn is None else self.match_cn[t]
        c2v = self._check_pass(ch.index_select(0, self.edge_var), self.cn0, match(0))
        iters = torch.zeros(batch, dtype=torch.int32, device=self.device)
        active = torch.ones(batch // tile, dtype=torch.bool, device=self.device)
        for i in range(i_max - 1):
            v2c = self._var_pass(ch, c2v, i)
            new = self._check_pass(v2c, self.cn[i], match(i + 1))
            cols = active.repeat_interleave(tile)
            c2v = torch.where(cols[None, :], new, c2v)
            iters = torch.where(cols, i + 1, iters)
            if early_exit:
                done = (self._unsatisfied(v2c).view(-1, tile) == 0).all(dim=1)
                active &= ~done
                if not bool(active.any()):
                    break
        return self._decide(ch, c2v, iters), iters

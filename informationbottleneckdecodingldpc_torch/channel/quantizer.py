"""Information-optimum AWGN channel-output quantizer for BPSK.

Port of ``channel/quantizer.py``: the tables are built once on the host in
numpy (fine grid + exact DP symmetric IB, the port's ``ib`` module); the
per-sample operations are plain PyTorch on float32 tables, so that cluster
boundaries agree exactly with the JAX side, which also compares in float32.
The keyed samplers draw their uniforms from the engine's Philox planes
(``sim/rng.py``) in place of ``jax.random``; :class:`AWGNChannelQuantizer`
binds the tables on one device.

Conventions (contracts with the decoders): bit 0 maps to +1; cluster labels
ascend with y; ``limits[T/2] = 0``; inversion sampling draws t ~ p(t|x=0)
and mirrors t -> T-1-t for bit 1.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from scipy.stats import norm

from ..ib import optimal_symmetric_quantizer


@dataclasses.dataclass(frozen=True)
class QuantizerTables:
    """Host arrays driving the quantizer ops."""

    sigma2: float
    ad_max_abs: float
    cardinality_t: int
    cardinality_y: int
    limits: np.ndarray  # [T] region lower borders in y-domain
    cdf_t_given_x0: np.ndarray  # [T+1] inversion-sampling cdf
    output_llrs: np.ndarray  # [T] natural-log LLR per cluster
    p_x_and_t: np.ndarray  # [T, 2] joint pmf
    mi_xt: float
    mi_xy: float


class DeviceQuantizerTables(NamedTuple):
    """The tables as float32 tensors on one device."""

    limits: torch.Tensor  # [T]
    cdf: torch.Tensor  # [T+1]
    llrs: torch.Tensor  # [T]


def build_quantizer_tables(
    sigma2: float,
    ad_max_abs: float = 3.0,
    cardinality_t: int = 16,
    cardinality_y: int = 2000,
) -> QuantizerTables:
    """Host-side construction of the quantizer (grid pmf + DP-IB clustering)."""
    y_vec = np.linspace(-ad_max_abs, ad_max_abs, cardinality_y)
    delta = y_vec[1] - y_vec[0]
    sigma = np.sqrt(sigma2)

    # p(y | x=0): Gaussian at +1, clipped tail mass folded into the border
    # cells.
    p0 = norm.pdf(y_vec, loc=1.0, scale=sigma) * delta
    p0[-1] += norm.sf((ad_max_abs - 1.0 + delta / 2) / sigma)
    p0[0] += 1.0 - norm.sf((-ad_max_abs - delta - 1.0 + delta / 2) / sigma)
    p1 = p0[::-1]
    p_xy = 0.5 * np.stack([p0, p1], axis=1)
    p_xy = p_xy / p_xy.sum()

    r = optimal_symmetric_quantizer(p_xy, cardinality_t)

    p_x_given_t = r.p_x_given_t / r.p_x_given_t.sum(axis=1, keepdims=True)
    p_x_and_t = p_x_given_t * r.p_t[:, None]
    p_t_given_x0 = p_x_and_t[:, 0] / 0.5
    cdf = np.concatenate([[0.0], np.cumsum(p_t_given_x0)])
    cdf[-1] = max(cdf[-1], 1.0)  # u < 1 always lands
    with np.errstate(divide="ignore"):
        output_llrs = np.log(p_x_and_t[:, 0]) - np.log(p_x_and_t[:, 1])

    limits = np.empty(cardinality_t)
    for t in range(cardinality_t):
        limits[t] = y_vec[np.nonzero(r.labels == t)[0].min()]
    limits[cardinality_t // 2] = 0.0

    return QuantizerTables(
        sigma2=float(sigma2),
        ad_max_abs=float(ad_max_abs),
        cardinality_t=int(cardinality_t),
        cardinality_y=int(cardinality_y),
        limits=limits,
        cdf_t_given_x0=cdf,
        output_llrs=output_llrs,
        p_x_and_t=p_x_and_t,
        mi_xt=r.mi_xt,
        mi_xy=r.mi_xy,
    )


def device_tables(
    tables: QuantizerTables, device: torch.device | str
) -> DeviceQuantizerTables:
    f32 = lambda a: torch.as_tensor(
        np.asarray(a, dtype=np.float32), device=device
    )
    return DeviceQuantizerTables(
        limits=f32(tables.limits),
        cdf=f32(tables.cdf_t_given_x0),
        llrs=f32(tables.output_llrs),
    )


def _threshold_count(thresholds: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """#{w : x > thresholds[w]} (int32) for ascending thresholds.

    ``searchsorted`` (left side) returns the first index whose threshold is
    >= x, which is exactly the count of thresholds strictly below x."""
    return torch.searchsorted(
        thresholds.contiguous(), x.contiguous(), out_int32=True
    )


def quantize_with(limits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """cluster = #{w in 1..T-1 : y > limits[w]}."""
    return _threshold_count(limits[1:], y)


def sample_clusters_from_uniform(
    cdf: torch.Tensor, u: torch.Tensor, bits: torch.Tensor
) -> torch.Tensor:
    """Inversion sampling t ~ p(t | x=bit) from float32 uniforms ``u``,
    mirrored for bit 1. Returns int32 clusters shaped like ``u``."""
    cardinality_t = cdf.shape[0] - 1
    t = _threshold_count(cdf[1:-1], u)
    return torch.where(bits.bool(), cardinality_t - 1 - t, t)


def quantize_llr_with(
    limits: torch.Tensor, llrs: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Float32 LLR of the quantized cluster of each received value."""
    return llrs[quantize_with(limits, y)]


def sample_llrs_from_uniform(
    cdf: torch.Tensor, llrs: torch.Tensor, u: torch.Tensor, bits: torch.Tensor
) -> torch.Tensor:
    """Float32 LLR of clusters inversion-sampled from the uniforms ``u``."""
    return llrs[sample_clusters_from_uniform(cdf, u, bits)]


def _keyed_uniforms(key: tuple[int, int], bits: torch.Tensor) -> torch.Tensor:
    """Float32 uniforms shaped like ``bits`` from the Philox key ``key``."""
    from ..sim import rng  # sim.rng imports this module

    if bits.dim() == 2:
        rows, batch = bits.shape
        return rng.draw("uniform", key, rows, 0, batch, bits.device)
    return rng.draw("uniform", key, 1, 0, bits.numel(), bits.device).reshape(bits.shape)


def sample_clusters_with(
    cdf: torch.Tensor, key: tuple[int, int], bits: torch.Tensor
) -> torch.Tensor:
    """Draw t ~ p(t | x=bit) by inversion, mirrored for bit 1, with the
    uniforms of the Philox key ``key`` (``sim/rng.py`` ``key_words``; not a
    JAX key, and not JAX's draws: threefry is not Philox).

    A 2-D ``bits`` is ``[rows, batch]``, the engine's layout: column j is
    codeword j of the uniform plane ``rng.draw("uniform", key, rows, 0,
    batch)``. Any other shape is drawn as one ``[1, numel]`` plane (one row
    per element, in row-major order) and reshaped back. The plane's counter
    holds codeword indices below 2^32 (``rng.check_plane`` refuses more
    columns). On a CUDA tensor the Philox kernel draws the plane (it
    launches or raises); on the CPU its plain version does."""
    return sample_clusters_from_uniform(cdf, _keyed_uniforms(key, bits), bits)


def sample_llrs_with(
    cdf: torch.Tensor, llrs: torch.Tensor, key: tuple[int, int], bits: torch.Tensor
) -> torch.Tensor:
    """Float32 LLR of the clusters :func:`sample_clusters_with` draws."""
    return llrs[sample_clusters_with(cdf, key, bits)]


class AWGNChannelQuantizer:
    """The quantizer's operations bound to its tables on one device.

    ``tables`` are the host tables, ``cardinality_t`` their |T|,
    ``device`` the ``torch.device`` and ``device_tables`` the float32 tables
    on it (the JAX class calls these tables ``device``). The device defaults
    to ``cuda``, as every entry point of the port does.
    A CPU tensor runs the plain functions; a CUDA tensor the same functions
    on the card, the keyed draws on the Philox kernel. A tensor on another
    device than the tables raises."""

    def __init__(
        self,
        sigma2: float,
        ad_max_abs: float = 3.0,
        cardinality_t: int = 16,
        cardinality_y: int = 2000,
        device: torch.device | str = "cuda",
    ):
        self.tables = build_quantizer_tables(sigma2, ad_max_abs, cardinality_t, cardinality_y)
        self.cardinality_t = self.tables.cardinality_t
        self.device = torch.device(device)
        self.device_tables = device_tables(self.tables, self.device)

    def quantize(self, y: torch.Tensor) -> torch.Tensor:
        return quantize_with(self.device_tables.limits, y)

    def quantize_llr(self, y: torch.Tensor) -> torch.Tensor:
        return quantize_llr_with(self.device_tables.limits, self.device_tables.llrs, y)

    def sample_clusters(self, key: tuple[int, int], bits: torch.Tensor) -> torch.Tensor:
        return sample_clusters_with(self.device_tables.cdf, key, bits)

    def sample_llrs(self, key: tuple[int, int], bits: torch.Tensor) -> torch.Tensor:
        return sample_llrs_with(self.device_tables.cdf, self.device_tables.llrs, key, bits)

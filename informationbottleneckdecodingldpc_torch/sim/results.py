"""Result persistence: JSON, and optional .npz, .mat and plot exports.

Port of ``sim/results.py`` with the same JSON keys, so the JAX package's
``load_results`` and ``scripts/make_parity_report.py`` read the port's files
as they stand. The sweep controller reloads the file to resume.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .engine import PointResult


def save_results(path: str, results: list[PointResult], partial: dict | None = None) -> None:
    """Atomically write the completed points and, optionally, the counters of
    the point in progress (``partial``: a ``PointCheckpoint`` as a dict),
    which resumes a sweep mid-point."""
    payload = {"points": [r.to_dict() for r in results]}
    if partial is not None:
        payload["partial"] = partial
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def load_results(path: str) -> list[PointResult]:
    with open(path) as f:
        payload = json.load(f)
    return [PointResult(**p) for p in payload["points"]]


def load_partial(path: str) -> dict | None:
    with open(path) as f:
        payload = json.load(f)
    return payload.get("partial")


def export_plot(path: str, results: list[PointResult], label: str = "") -> None:
    """BER against Eb/N0 on a log scale; skipped when matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots()
    ax.semilogy(
        [r.ebn0_db for r in results], [max(r.ber, 1e-12) for r in results],
        marker="o", label=label or None,
    )
    ax.set_xlabel("Eb/N0 (dB)")
    ax.set_ylabel("BER")
    ax.grid(True, which="both", alpha=0.4)
    if label:
        ax.legend()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def export_npz(path: str, results: list[PointResult]) -> None:
    """Eb/N0, BER and FER vectors in the reference's ``np.savez`` layout."""
    np.savez(
        path,
        EbN0_dB_vector=np.array([r.ebn0_db for r in results]),
        BER_vector=np.array([r.ber for r in results]),
        FER_vector=np.array([r.fer for r in results]),
    )


def export_mat(path: str, results: list[PointResult], decoder_name: str = "") -> None:
    """MATLAB export of the reference's ``savemat`` dict."""
    import scipy.io as sio

    sio.savemat(
        path,
        {
            "EbN0_dB_vector": np.array([r.ebn0_db for r in results]),
            "BER_vector": np.array([r.ber for r in results]),
            "decoder_name": decoder_name,
        },
    )

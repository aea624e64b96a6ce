"""Unified parity-check-matrix I/O.

The reference duplicates ``load_check_mat``/``load_sparse_csr`` across five
classes (SURVEY.md §2.1); this module is the single equivalent. Supported:
``.alist``/text AList, ``.npy`` dense, ``.npz`` scipy-CSR (keys
``data/indices/indptr/shape``, matching the reference's convention,
discrete_LDPC_decoder_irreg.py:102-119), and ``.mat`` (variable ``H``, the
reference's WLAN export, generate_802.11_matrix.py:41-43) — so matrices
produced by the reference tooling drop straight in.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .alist import alist_to_csr, csr_to_alist


def load_check_matrix(path: str) -> sp.csr_matrix:
    """Load H from .npy (dense), .npz (CSR fields), .mat, or AList text."""
    if path.endswith(".npy"):
        H = np.load(path)
        return sp.csr_matrix(H.astype(np.int8))
    if path.endswith(".npz"):
        loader = np.load(path)
        return sp.csr_matrix(
            (loader["data"], loader["indices"], loader["indptr"]),
            shape=tuple(loader["shape"]),
        )
    if path.endswith(".mat"):
        from scipy.io import loadmat

        md = loadmat(path)
        keys = [k for k in md if not k.startswith("__")]
        name = "H" if "H" in md else keys[0]
        H = md[name]
        if sp.issparse(H):
            return sp.csr_matrix(H).astype(np.int8)
        return sp.csr_matrix(np.asarray(H).astype(np.int8))
    return alist_to_csr(path)


def save_check_matrix(H: sp.spmatrix, path: str) -> None:
    """Save H as .npz (CSR fields), .npy (dense), or AList text by extension."""
    H = sp.csr_matrix(H)
    if path.endswith(".npz"):
        np.savez(
            path,
            data=H.data,
            indices=H.indices,
            indptr=H.indptr,
            shape=np.asarray(H.shape),
        )
    elif path.endswith(".npy"):
        np.save(path, H.toarray().astype(np.int8))
    elif path.endswith(".mat"):
        from scipy.io import savemat

        savemat(path, {"H": H.astype(np.float64)})
    else:
        csr_to_alist(H, path)

"""The kd-tree ANN matcher, `--matcher ann`: the reference's host-side
approximate search (its C++ kd-tree, `native/ann.cpp`, through
`utils/native.py`).

The matcher copies the level's feature tables to the host, queries the
cached tree and copies the indices and distances back to the run's
device; eager PyTorch needs no callback into a traced graph.  At
`ann_eps = 0` the search is exact (the brute matcher's metric, equal
fields except at ties, the tree breaking ties toward the lowest index);
larger eps trades quality for speed with the (1 + eps) distance
guarantee.  Kappa coherence composes on top through `CoherenceWrapper`,
as for brute.  Without a buildable library the matcher falls back to
the exact search with a warning, as the reference does.

The tree's indices need no clamp before `flat_to_nnf`'s gathers: every
query starts from row 0 and only takes rows of the tree, so each index
lies in [0, rows of A).
"""

from __future__ import annotations

import collections
import ctypes
import logging
import threading

import numpy as np
import torch

from ..config import SynthConfig
from .brute import exact_nn
from .coherence import CoherenceWrapper
from .matcher import Matcher, flat_to_nnf, register_matcher

log = logging.getLogger("image_analogies_tpu_torch")


class _TreeEntry:
    """A cached kd-tree and what makes eviction safe: `refs` counts the
    queries in flight, and an entry evicted while referenced is freed by
    its last releaser, since a query runs outside the cache lock."""

    __slots__ = ("tree", "refs", "evicted")

    def __init__(self, tree):
        self.tree = tree
        self.refs = 0
        self.evicted = False


# One tree a pyramid level serves every EM step of that level; keyed on
# the full content hash of the A table (a false hit would corrupt the
# matches).  Only the key and the native handle are kept (the tree owns
# its copy of the rows); LRU order, oldest evicted first.
_TREE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_TREE_CACHE_CAP = 4
_tree_lock = threading.Lock()


def _free_tree(lib, tree) -> None:
    """The one place native trees are freed (tests replace it)."""
    lib.ann_free(tree)


def _acquire_tree(f_a: np.ndarray) -> _TreeEntry:
    """Look up (or build) the tree of `f_a` and take a query reference;
    pair with `_release_tree`.  Builds run under the lock (once a
    level)."""
    from ..utils.native import load_ann

    lib = load_ann()
    key = (f_a.shape, hash(f_a.tobytes()))
    with _tree_lock:
        entry = _TREE_CACHE.get(key)
        if entry is None:
            f32p = ctypes.POINTER(ctypes.c_float)
            tree = lib.ann_build(
                f_a.ctypes.data_as(f32p), f_a.shape[0], f_a.shape[1]
            )
            entry = _TreeEntry(tree)
            _TREE_CACHE[key] = entry
            while len(_TREE_CACHE) > _TREE_CACHE_CAP:
                _, old = _TREE_CACHE.popitem(last=False)
                if old.refs == 0:
                    _free_tree(lib, old.tree)
                else:
                    old.evicted = True
        else:
            _TREE_CACHE.move_to_end(key)
        entry.refs += 1
        return entry


def _release_tree(entry: _TreeEntry) -> None:
    from ..utils.native import load_ann

    with _tree_lock:
        entry.refs -= 1
        if entry.evicted and entry.refs == 0:
            _free_tree(load_ann(), entry.tree)


def _host_ann_query(f_b_flat: np.ndarray, f_a_flat: np.ndarray, eps: float):
    """Query the (cached) tree of `f_a_flat` for every row of `f_b_flat`
    on the host: (idx (N,) int32, squared distances (N,) float32)."""
    from ..utils.native import load_ann

    lib = load_ann()
    f_a = np.ascontiguousarray(f_a_flat, np.float32)
    f_b = np.ascontiguousarray(f_b_flat, np.float32)
    n_q = f_b.shape[0]
    idx = np.empty(n_q, np.int32)
    dist = np.empty(n_q, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    entry = _acquire_tree(f_a)
    try:
        lib.ann_query(
            entry.tree,
            f_b.ctypes.data_as(f32p),
            n_q,
            ctypes.c_float(eps),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dist.ctypes.data_as(f32p),
        )
    finally:
        _release_tree(entry)
    return idx, dist


class AnnMatcher(Matcher):
    """The host kd-tree's nearest neighbours; the exact search when the
    native library cannot be built.  Exact and approximate search alike
    have no temporal term: `temporal` is accepted and ignored."""

    name = "ann"

    def match(self, f_b, f_a, nnf, *, level, cfg: SynthConfig, draws=None,
              raw=None, polish_iters=None, temporal=None):
        from ..utils.native import ann_available

        h, w, d = f_b.shape
        wa = f_a.shape[1]
        f_b_flat = f_b.reshape(-1, d).float()
        f_a_flat = f_a.reshape(-1, d).float()
        if not ann_available():
            log.warning("native ANN library unavailable; ann matcher "
                        "falling back to the exact search")
            idx, dist = exact_nn(f_b_flat, f_a_flat,
                                 chunk=min(cfg.brute_chunk, h * w))
        else:
            idx_np, dist_np = _host_ann_query(
                f_b_flat.cpu().numpy(), f_a_flat.cpu().numpy(),
                float(cfg.ann_eps))
            idx = torch.from_numpy(idx_np).to(f_b.device)
            dist = torch.from_numpy(dist_np).to(f_b.device)
        return flat_to_nnf(idx, wa, (h, w)), dist.reshape(h, w)


# As for brute: kappa coherence composes on top.
register_matcher("ann", CoherenceWrapper(AnnMatcher()))

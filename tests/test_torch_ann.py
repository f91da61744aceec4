"""The port's kd-tree ANN matcher against the reference, on the CPU: the
cases of tests/test_ann.py (the tree's exactness at eps 0, the eps
guarantee, duplicate rows; the tree cache's LRU order and deferred
frees; the matcher against exact search, over a frame stack, end to end
against brute, with kappa), and the two packages on the same features:
at eps 0 the port's indices equal the JAX `AnnMatcher`'s (one
deterministic tree, built from the same source) and its distances equal
`exact_nn`'s within rtol 1e-5.  The native library runs its OpenMP loop
in the process of torch's thread pool; this file holds both to one
thread."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_analogies_tpu.config import SynthConfig as JCfg
from image_analogies_tpu.models import get_matcher as j_get_matcher
from image_analogies_tpu.models.ann import _host_ann_query as j_query
from image_analogies_tpu_torch import SynthConfig, create_image_analogy, psnr
from image_analogies_tpu_torch.models import ann as ann_mod
from image_analogies_tpu_torch.models import get_matcher
from image_analogies_tpu_torch.models.ann import _host_ann_query
from image_analogies_tpu_torch.models.brute import exact_nn
from image_analogies_tpu_torch.utils import native


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and so for the library's OpenMP
    loop (omp_set_num_threads on the calling thread, the runtime torch
    loaded)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def needs_native():
    if not native.ann_available():
        pytest.skip("native ANN library not buildable (no g++/OpenMP)")


def cpu_cfg(**kw):
    return SynthConfig(device="cpu", **kw)


class TestKdTree:
    def test_exact_at_eps_zero(self, rng, needs_native):
        f_a = rng.standard_normal((500, 12)).astype(np.float32)
        f_b = rng.standard_normal((200, 12)).astype(np.float32)
        idx, dist = _host_ann_query(f_b, f_a, eps=0.0)
        d2 = ((f_b[:, None] - f_a[None]) ** 2).sum(-1)
        np.testing.assert_allclose(dist, d2.min(1), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            ((f_b - f_a[idx]) ** 2).sum(-1), d2.min(1), rtol=1e-5, atol=1e-6)
        # The same tree from the same source: the JAX package's indices.
        j_idx, j_dist = j_query(f_b, f_a, eps=0.0)
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_array_equal(dist, j_dist)

    def test_eps_guarantee(self, rng, needs_native):
        f_a = rng.standard_normal((800, 16)).astype(np.float32)
        f_b = rng.standard_normal((300, 16)).astype(np.float32)
        eps = 1.0
        idx, dist = _host_ann_query(f_b, f_a, eps=eps)
        d2min = ((f_b[:, None] - f_a[None]) ** 2).sum(-1).min(1)
        assert (dist <= d2min * (1.0 + eps) ** 2 + 1e-5).all()
        assert (dist >= d2min - 1e-5).all()
        np.testing.assert_array_equal(idx, j_query(f_b, f_a, eps=eps)[0])

    def test_duplicate_rows(self, needs_native):
        f_a = np.ones((100, 8), np.float32)
        f_a[50:] = 2.0
        f_b = np.full((10, 8), 1.1, np.float32)
        idx, dist = _host_ann_query(f_b, f_a, eps=0.0)
        np.testing.assert_allclose(dist, 0.1**2 * 8, rtol=1e-4)
        assert (idx < 50).all()


class TestTreeCache:
    """LRU order and deferred frees of the host-side tree cache."""

    @pytest.fixture(autouse=True)
    def _fresh_cache(self, monkeypatch, needs_native):
        monkeypatch.setattr(ann_mod, "_TREE_CACHE",
                            type(ann_mod._TREE_CACHE)())
        self.freed = []
        monkeypatch.setattr(ann_mod, "_free_tree",
                            lambda lib, tree: self.freed.append(tree))

    @staticmethod
    def _tables(n):
        rng = np.random.default_rng(0)
        return [np.ascontiguousarray(rng.standard_normal((40 + i, 6)),
                                     np.float32) for i in range(n)]

    def test_evicts_oldest_first(self):
        cap = ann_mod._TREE_CACHE_CAP
        tables = self._tables(cap + 1)
        entries = []
        for t in tables:
            e = ann_mod._acquire_tree(t)
            ann_mod._release_tree(e)
            entries.append(e)
        assert self.freed == [entries[0].tree]
        assert len(ann_mod._TREE_CACHE) == cap
        e = ann_mod._acquire_tree(tables[-1])
        ann_mod._release_tree(e)
        assert e.tree == entries[-1].tree
        assert self.freed == [entries[0].tree]
        assert len(ann_mod._TREE_CACHE) == cap

    def test_lru_refresh_on_hit(self):
        cap = ann_mod._TREE_CACHE_CAP
        tables = self._tables(cap + 1)
        first = ann_mod._acquire_tree(tables[0])
        ann_mod._release_tree(first)
        for t in tables[1:cap]:
            ann_mod._release_tree(ann_mod._acquire_tree(t))
        ann_mod._release_tree(ann_mod._acquire_tree(tables[0]))
        second = ann_mod._TREE_CACHE[list(ann_mod._TREE_CACHE.keys())[0]]
        ann_mod._release_tree(ann_mod._acquire_tree(tables[cap]))
        assert self.freed == [second.tree]
        assert not first.evicted

    def test_free_deferred_while_referenced(self):
        cap = ann_mod._TREE_CACHE_CAP
        tables = self._tables(cap + 1)
        held = ann_mod._acquire_tree(tables[0])
        for t in tables[1:]:
            ann_mod._release_tree(ann_mod._acquire_tree(t))
        assert held.evicted and held.tree not in self.freed
        ann_mod._release_tree(held)
        assert self.freed == [held.tree]

    def test_no_feature_table_retained(self):
        import sys

        t = self._tables(1)[0]
        before = sys.getrefcount(t)
        ann_mod._release_tree(ann_mod._acquire_tree(t))
        assert sys.getrefcount(t) == before


class TestAnnMatcher:
    def test_matches_brute_dists_at_eps_zero(self, rng, needs_native):
        """At eps 0: distances equal exact_nn's within rtol 1e-5, and the
        field equals the JAX AnnMatcher's on the same features."""
        cfg = cpu_cfg(matcher="ann", ann_eps=0.0)
        f_a = rng.standard_normal((12, 12, 10)).astype(np.float32)
        f_b = rng.standard_normal((11, 13, 10)).astype(np.float32)
        nnf, dist = get_matcher("ann").match(
            torch.from_numpy(f_b), torch.from_numpy(f_a),
            torch.zeros(11, 13, 2, dtype=torch.long), level=0, cfg=cfg)
        _, d_exact = exact_nn(torch.from_numpy(f_b).reshape(-1, 10),
                              torch.from_numpy(f_a).reshape(-1, 10))
        np.testing.assert_allclose(dist.numpy().reshape(-1), d_exact.numpy(),
                                   rtol=1e-5, atol=1e-6)
        j_nnf, j_dist = j_get_matcher("ann").match(
            jnp.asarray(f_b), jnp.asarray(f_a),
            jnp.zeros((11, 13, 2), jnp.int32), key=jax.random.PRNGKey(0),
            level=0, cfg=JCfg(matcher="ann", ann_eps=0.0))
        np.testing.assert_array_equal(nnf.numpy(), np.asarray(j_nnf))
        np.testing.assert_array_equal(dist.numpy(), np.asarray(j_dist))

    def test_works_over_a_frame_stack(self, rng, needs_native):
        """The level body's entry (`match_frames`), where the reference's
        test runs the matcher under jit: one tree serves every frame."""
        cfg = cpu_cfg(matcher="ann", ann_eps=0.5)
        f_a = torch.from_numpy(
            rng.standard_normal((10, 10, 8)).astype(np.float32))
        f_b = torch.from_numpy(
            rng.standard_normal((2, 10, 10, 8)).astype(np.float32))
        nnf, dist = get_matcher("ann").match_frames(
            f_b, f_a, torch.zeros(2, 10, 10, 2, dtype=torch.long), level=0,
            cfg=cfg)
        assert nnf.shape == (2, 10, 10, 2) and nnf.dtype == torch.int64
        assert float(dist.min()) >= 0.0
        assert int(nnf.min()) >= 0 and int(nnf.max()) < 10

    def test_end_to_end_synthesis(self, needs_native):
        """ann at eps 0 tracks the brute oracle end to end."""
        from image_analogies_tpu_torch.utils.examples import (
            texture_by_numbers,
        )

        a, ap, b = texture_by_numbers(48)
        kw = dict(levels=2, em_iters=2)
        bp_ann = create_image_analogy(a, ap, b, cpu_cfg(
            matcher="ann", ann_eps=0.0, **kw))
        bp_brute = create_image_analogy(a, ap, b, cpu_cfg(
            matcher="brute", **kw))
        assert psnr(bp_ann, bp_brute) > 30.0

    def test_kappa_composes(self, rng, needs_native):
        cfg = cpu_cfg(matcher="ann", ann_eps=0.0, kappa=5.0)
        f_a = torch.from_numpy(
            rng.standard_normal((9, 9, 8)).astype(np.float32))
        f_b = torch.from_numpy(
            rng.standard_normal((9, 9, 8)).astype(np.float32))
        nnf, dist = get_matcher("ann").match(
            f_b, f_a, torch.zeros(9, 9, 2, dtype=torch.long), level=1,
            cfg=cfg)
        assert nnf.shape == (9, 9, 2)
        assert type(get_matcher("ann")).__name__ == "CoherenceWrapper"


def test_falls_back_to_exact_search_with_a_warning(rng, monkeypatch, caplog):
    """Without a buildable library the matcher takes the exact search,
    as the reference does, and says so."""
    monkeypatch.setattr(native, "ann_available", lambda: False)
    cfg = cpu_cfg(matcher="ann", ann_eps=0.0)
    f_a = torch.from_numpy(rng.standard_normal((8, 8, 6)).astype(np.float32))
    f_b = torch.from_numpy(rng.standard_normal((7, 9, 6)).astype(np.float32))
    nnf, dist = get_matcher("ann").match(
        f_b, f_a, torch.zeros(7, 9, 2, dtype=torch.long), level=0, cfg=cfg)
    idx, d_exact = exact_nn(f_b.reshape(-1, 6), f_a.reshape(-1, 6))
    assert "falling back to the exact search" in caplog.text
    np.testing.assert_array_equal(dist.numpy().reshape(-1), d_exact.numpy())
    np.testing.assert_array_equal(
        (nnf[..., 0] * 8 + nnf[..., 1]).reshape(-1).numpy(), idx.numpy())


def test_library_builds_into_the_port_build_dir(needs_native):
    """The port's own library, named by the source's content hash, under
    build/ia_torch_native/ (the reference builds native/build/)."""
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "ia_torch_native")
    assert path.exists()

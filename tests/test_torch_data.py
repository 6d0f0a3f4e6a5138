"""The port's data engine against the JAX package's, on the CPU.

The same seeds and inputs go through ``patchaugnet_tpu.data`` and
``patchaugnet_tpu_torch.data``: the retrieval engine (indices equal,
duplicate database rows included, where ties go to the lowest index),
the recall bookkeeping (the golden cases of ``tests/test_data.py``, run
against the port), the synthetic scene and its tuples, the tuple sampler
with its overlap entries, the correspondence tables, dataset creation
from CSVs, the pickles of the JAX package, the .pb overlap records, hard
negatives and the top-k dumps. Indices and records are exactly equal;
distances agree within 1e-5 (f32 sums in another order).

The JAX package draws from the global ``random`` and ``np.random`` where
the port takes generators: seeding the former and passing
``random.Random(seed)`` / ``np.random.RandomState(seed)`` gives the same
draws.
"""
import os
import random

import numpy as np
import pytest
import torch

from patchaugnet_tpu import data as J
from patchaugnet_tpu.data import overlap as joverlap
from patchaugnet_tpu.data import retrieval as jretrieval

from patchaugnet_tpu_torch import data as P
from patchaugnet_tpu_torch.data import overlap as poverlap
from patchaugnet_tpu_torch.data import retrieval

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are small, and a thread pool per
    test process spins against the other pytest workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _with_duplicates(rng, n, d):
    """Random rows with exact duplicates: rows 3, 10 and 41 equal, 20 and 7."""
    db = rng.randn(n, d).astype(np.float32)
    db[10] = db[3]
    db[41] = db[3]
    db[7] = db[20]
    return db


def _jax_scene(for_training, n_per_trip=12, num_points=64):
    ds = J.SceneDataset("synthetic", for_training=for_training)
    ds.create_synthetic(n_trips=2, n_per_trip=n_per_trip, num_points=num_points)
    return ds


def _port_scene(for_training, n_per_trip=12, num_points=64):
    ds = P.SceneDataset("synthetic", for_training=for_training, device=CPU)
    ds.create_synthetic(n_trips=2, n_per_trip=n_per_trip, num_points=num_points)
    return ds


def _assert_records_equal(jrec, prec):
    assert list(jrec["file"]) == prec.file
    np.testing.assert_array_equal(jrec["northing"].to_numpy(np.float64), prec.northing)
    np.testing.assert_array_equal(jrec["easting"].to_numpy(np.float64), prec.easting)


def _assert_scenes_equal(j, p):
    assert j.trip_names == p.trip_names
    _assert_records_equal(j.records, p.records)
    assert j.records_size_list == p.records_size_list
    assert j.valid_indices_list == p.valid_indices_list
    assert sorted(j.tuples) == sorted(p.tuples)
    for key, jt in j.tuples.items():
        pt = p.tuples[key]
        assert sorted(jt) == sorted(pt), key
        for q in jt:
            assert jt[q].positive_indices == pt[q].positive_indices, (key, q)
            assert jt[q].negative_indices == pt[q].negative_indices, (key, q)


def _assert_entries_equal(a, b):
    """Overlap entries equal; near-lists compared sorted (sklearn returns
    them unordered, scipy sorted)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.idx1 == y.idx1
        assert sorted(x.near_indices2) == sorted(y.near_indices2)
        assert list(x.far_indices2) == list(y.far_indices2)
        assert list(x.bad_far_indices2) == list(y.bad_far_indices2)


def _assert_corr_equal(jcorr, pcorr):
    for name in jcorr._fields[:7]:
        np.testing.assert_array_equal(np.asarray(getattr(jcorr, name)), getattr(pcorr, name).numpy(), err_msg=name)
    assert jcorr.num_pairs == pcorr.num_pairs


class TestRetrieval:
    @pytest.mark.parametrize("chunk", [8, 4096])
    def test_topk_neighbors_match_jax(self, chunk):
        """Indices equal to ``lax.top_k``'s, ties among the duplicate rows
        in index order; the queries include copies of duplicated rows (a
        tie at distance 0)."""
        rng = np.random.RandomState(0)
        db = _with_duplicates(rng, 100, 8)
        q = np.concatenate([rng.randn(17, 8).astype(np.float32), db[[3, 20, 41]]])
        jd, ji = jretrieval.topk_neighbors(q, db, 12, chunk=chunk)
        pd_, pi = retrieval.topk_neighbors(q, db, 12, chunk=chunk, device=CPU)
        np.testing.assert_array_equal(ji, pi)
        np.testing.assert_allclose(jd, pd_, rtol=1e-5, atol=1e-5)
        assert list(pi[17, :3]) == [3, 10, 41] and list(pi[18, :2]) == [7, 20]

    def test_ties_go_to_the_lowest_index(self):
        """All-equal rows: every query ranks the database in index order
        (``torch.topk`` alone promises no order among equal values)."""
        db = np.ones((40, 4), np.float32)
        q = np.ones((3, 4), np.float32)
        _, idx = retrieval.topk_neighbors(q, db, 40, device=CPU)
        np.testing.assert_array_equal(idx, np.tile(np.arange(40), (3, 1)))
        keys = retrieval._ordered_keys(torch.tensor([[-1.0, -0.0, 0.0, 2.0, -2.0, float("inf")]]))
        order = torch.argsort(keys, dim=-1)[0].tolist()
        assert order == [4, 0, 1, 2, 3, 5]           # -2, -1, -0 ~ 0 by index, 2, inf

    def test_hard_negatives_batch_matches_jax(self):
        """Masked sweeps over candidate lists with duplicate rows, some
        lists below the threshold (they yield [])."""
        rng = np.random.RandomState(3)
        n_rec, k = 120, 5
        descs = _with_duplicates(rng, n_rec, 16)
        neg_lists = [list(rng.choice(n_rec, size=rng.randint(0, 40), replace=False)) for _ in range(n_rec)]
        neg_lists[0] = [41, 3, 10, 20, 7, 60]
        want = jretrieval.hard_negatives_batch(descs[:90], descs, neg_lists[:90], num_hard_neg=k, chunk=64)
        got = retrieval.hard_negatives_batch(descs[:90], descs, neg_lists[:90], num_hard_neg=k, chunk=64,
                                             device=CPU)
        assert got == want
        ties = [i for i in got[0] if i in (3, 10, 41)]
        assert ties == sorted(ties) and ties                # equal distances in index order
        for q in (1, 2, 5):
            assert retrieval.hard_negatives(descs[q], descs, neg_lists[q], k, device=CPU) == \
                jretrieval.hard_negatives(descs[q], descs, neg_lists[q], k)


class TestRecallBookkeeping:
    """The golden cases of ``tests/test_data.py::TestRecallBookkeeping``
    (the reference's exact semantics, scene_dataset.py:1016-1099), run
    against the port."""

    def test_perfect_retrieval(self, rng):
        db = rng.randn(50, 16).astype(np.float32)
        q = db[:20] + 1e-4
        res = retrieval.recall_precision(
            q, db, list(range(100, 150)), list(range(200, 220)),
            {200 + i: {100 + i} for i in range(20)}, top_k=5, device=CPU,
        )
        assert res.num_evaluated == 20
        np.testing.assert_allclose(res.recall, 100.0)
        assert res.one_percent_recall == 100.0
        assert res.lost == 0
        assert res.threshold == 1

    def test_positive_at_rank2(self, rng):
        db = np.zeros((10, 4), np.float32)
        db[0] = [0.1, 0, 0, 0]
        db[1] = [0.2, 0, 0, 0]
        db[2:] = 10.0
        q = np.zeros((1, 4), np.float32)
        res = retrieval.recall_precision(q, db, list(range(10)), [99], {99: {1}}, top_k=5, device=CPU)
        assert res.recall[0] == 0.0
        assert (res.recall[1:] == 100.0).all()

    def test_skip_self_keeps_rank_slot(self, rng):
        db = np.zeros((10, 4), np.float32)
        db[1] = [0.2, 0, 0, 0]
        db[2:] = 10.0
        q = np.zeros((1, 4), np.float32)
        res = retrieval.recall_precision(q, db, list(range(10)), [0], {0: {1}}, top_k=5, add_one_more=False,
                                         device=CPU)
        assert res.recall[0] == 0.0
        assert res.recall[1] == 100.0

    def test_add_one_more_drops_leading_self(self, rng):
        db = np.zeros((10, 4), np.float32)
        db[1] = [0.2, 0, 0, 0]
        db[2:] = 10.0
        q = np.zeros((1, 4), np.float32)
        res = retrieval.recall_precision(q, db, list(range(10)), [0], {0: {1}}, top_k=5, add_one_more=True,
                                         device=CPU)
        assert res.recall[0] == 100.0

    def test_queries_without_positives_skipped(self, rng):
        db = rng.randn(20, 4).astype(np.float32)
        q = rng.randn(3, 4).astype(np.float32)
        res = retrieval.recall_precision(q, db, list(range(20)), [50, 51, 52], {50: {3}}, top_k=5, device=CPU)
        assert res.num_evaluated == 1

    def test_one_percent_threshold(self):
        db = np.random.RandomState(0).randn(250, 4).astype(np.float32)
        q = db[:1] + 1e-5
        res = retrieval.recall_precision(q, db, list(range(250)), [999], {999: {0}}, top_k=5, device=CPU)
        assert res.threshold == 2


class TestScene:
    @pytest.mark.parametrize("for_training", [True, False], ids=["train", "test"])
    def test_synthetic_scene_matches_jax(self, for_training):
        """Records, trips, tuples and valid indices equal; the clouds bit-equal."""
        j, p = _jax_scene(for_training), _port_scene(for_training)
        _assert_scenes_equal(j, p)
        np.testing.assert_array_equal(j._clouds, p._clouds)
        assert p.records.columns[0] == "file" and len(p) == 24

    def test_tuple_batches_match_jax(self):
        """Two batches of ``iter_epoch``: clouds bit-equal, the same
        indices and the same overlap entries."""
        kw = dict(num_pos=2, num_neg=4, load_overlap_indices=True, num_points=64, seed=0)
        j = J.PlaceRecognitionDataset("synthetic", True, **kw)
        p = P.PlaceRecognitionDataset("synthetic", True, device=CPU, **kw)
        batches = 0
        for bj, bp in zip(j.iter_epoch(2), p.iter_epoch(2)):
            np.testing.assert_array_equal(bj.clouds, bp.clouds)
            assert bj.query_indices == bp.query_indices
            assert list(bj.nn_dict) == list(bp.nn_dict)
            for key in bj.nn_dict:
                _assert_entries_equal(bj.nn_dict[key], bp.nn_dict[key])
            batches += 1
            if batches == 2:
                break
        assert batches == 2

    def test_hard_negative_mining_matches_jax(self):
        j, p = _jax_scene(True), _port_scene(True)
        descs = np.random.RandomState(0).randn(24, 8).astype(np.float32)
        j.global_descs, p.global_descs = descs, descs.copy()
        np.random.seed(4)
        j.mine_hard_negatives(num_hard_neg=3, num_sample_neg=5)
        p.mine_hard_negatives(num_hard_neg=3, num_sample_neg=5, rng=np.random.RandomState(4))
        assert j.hard_negative_indices == p.hard_negative_indices
        assert len(p.hard_negative_indices) > 0

    def test_recall_and_top_k_dumps_match_jax(self):
        """make_descs with a fake forward (the mean point), recall per trip
        pair, and the feature and euclidean top-k dumps of both splits."""
        def fake_forward(clouds):
            return np.asarray(clouds).mean(axis=1)

        for for_training in (True, False):
            j, p = _jax_scene(for_training), _port_scene(for_training)
            j.make_descs(fake_forward, batch_size=5)
            p.make_descs(lambda c: torch.from_numpy(fake_forward(c)), batch_size=5)
            np.testing.assert_array_equal(j.global_descs, p.global_descs)
            jr, pr = j.recall_precision_all(top_k=5), p.recall_precision_all(top_k=5)
            assert sorted(jr) == sorted(pr)
            for key in jr:
                np.testing.assert_array_equal(jr[key].recall, pr[key].recall)
                np.testing.assert_array_equal(jr[key].precision, pr[key].precision)
                assert jr[key].one_percent_recall == pr[key].one_percent_recall
            assert repr(j.find_top_k_feat(top_k=6)) == repr(p.find_top_k_feat(top_k=6))
            assert repr(j.find_top_k_euc(top_k=6)) == repr(p.find_top_k_euc(top_k=6))


class TestOverlap:
    @pytest.mark.parametrize("mode", ["default", "hard_negative", "not_emulated"])
    def test_build_correspondences_match_jax(self, mode):
        """Tables from the overlap entries of a synthetic batch and 48
        centres per cloud, at most 20 entries per pair (drawn with
        ``rng``), negatives drawn with ``np_rng``."""
        p = P.PlaceRecognitionDataset("synthetic", True, num_pos=2, num_neg=4, load_overlap_indices=True,
                                      num_points=64, seed=0, device=CPU)
        batch = next(p.iter_epoch(2))
        rng = np.random.RandomState(1)
        centers = np.stack([rng.permutation(64)[:48] for _ in range(batch.clouds.shape[0])]).astype(np.int32)
        kw = dict(max_rows=256, max_pairs=4, max_entries_per_pair=20,
                  use_hard_negative_patches=mode == "hard_negative",
                  emulate_reference_far_sampling=mode != "not_emulated")
        random.seed(5)
        np.random.seed(5)
        want = joverlap.build_correspondences(batch.nn_dict, centers, **kw)
        got = poverlap.build_correspondences(batch.nn_dict, centers, rng=random.Random(5),
                                             np_rng=np.random.RandomState(5), **kw)
        _assert_corr_equal(want, got)
        assert got.row_valid.sum() > 0 and got.row_q_cloud.dtype == torch.int32

    def test_synthetic_overlaps_match_jax(self):
        rng = np.random.RandomState(0)
        q = rng.rand(256, 3).astype(np.float32)
        pos = q + rng.randn(256, 3).astype(np.float32) * 0.01
        want = joverlap.synthetic_overlaps(q, pos, n_entries=64, rng=np.random.RandomState(2))
        got = poverlap.synthetic_overlaps(q, pos, n_entries=64, rng=np.random.RandomState(2))
        _assert_entries_equal(want, got)
        assert all(e.near_indices2 == sorted(e.near_indices2) for e in got)

    def test_pb_records_read_both_ways(self, tmp_path):
        entries = {7: [P.OverlapEntry(5, [1, 2], [10, 11], [20])], 9: [P.OverlapEntry(3, [4], [], [6, 8])]}
        poverlap.save_overlap_pb(str(tmp_path / "port.pb"), entries, query_idx=3)
        joverlap.save_overlap_pb(str(tmp_path / "jax.pb"), entries, query_idx=3)
        assert (tmp_path / "port.pb").read_bytes() == (tmp_path / "jax.pb").read_bytes()
        for got in (poverlap.load_overlap_pb(str(tmp_path / "jax.pb")),
                    joverlap.load_overlap_pb(str(tmp_path / "port.pb"))):
            assert sorted(got) == [7, 9]
            for key in entries:
                _assert_entries_equal(entries[key], got[key])


def _write_csv_tree(root, rng):
    """Two Oxford-format trips (CSVs of timestamp, northing, easting, rows
    out of timestamp order, coordinates to 6 decimals as the benchmark
    CSVs hold them), some submaps inside Oxford's test region."""
    base = os.path.join(root, "oxford")
    for t, trip in enumerate(("2014-11-14-16-34-33", "2014-11-18-13-20-12")):     # two of Oxford's test trips
        n = 14
        stamps = 1400000000000000 + rng.permutation(n) * 1000 + t
        i = np.arange(n)
        inside = i < 4                          # in the box around (5735237, 620543)
        north = np.where(inside, 5735300.0, 5735000.0 - 300.0 * (i % 5)) + rng.rand(n) * 3.0
        east = np.where(inside, 620450.0 + i * 3.0, 620300.0 + (i % 7) * 4.0) + rng.rand(n)
        for submap_type in ("pointcloud_20m_10overlap", "pointcloud_20m"):     # train, test
            os.makedirs(os.path.join(base, trip, submap_type))
            with open(os.path.join(base, trip, submap_type + ".csv"), "w") as f:
                f.write("timestamp,northing,easting\n")
                for s, a, b in zip(stamps, north, east):
                    f.write(f"{s},{a:.6f},{b:.6f}\n")


@pytest.mark.parametrize("for_training", [True, False], ids=["train", "test"])
def test_create_from_csvs_matches_jax(tmp_path, monkeypatch, for_training):
    """``create`` on a CSV tree: records (sorted by timestamp, the test
    region carved out of the train split), tuples and valid indices equal;
    the port's pickles read back without pandas objects in them."""
    _write_csv_tree(str(tmp_path), np.random.RandomState(0))
    monkeypatch.setenv(J.DATA_ROOT_ENV, str(tmp_path))
    j = J.SceneDataset("oxford", for_training=for_training)
    j.create(save=False)
    p = P.SceneDataset("oxford", for_training=for_training, device=CPU)
    p.create()
    _assert_scenes_equal(j, p)
    assert 0 < len(p) <= 28 and sum(len(v) for v in p.valid_indices_list) > 0
    back = P.SceneDataset("oxford", for_training=for_training, device=CPU)
    assert back.load()
    _assert_scenes_equal(j, back)
    with open(os.path.join(p.pickle_dir(), f"{p.dataset_type}_records.pickle"), "rb") as f:
        assert b"pandas" not in f.read()


def test_reads_the_jax_packages_pickles(tmp_path, monkeypatch):
    """A scene pickled by the JAX package (records as a DataFrame) reads
    back to the same records and tuples."""
    monkeypatch.setenv(J.DATA_ROOT_ENV, str(tmp_path))
    j = _jax_scene(True, n_per_trip=8, num_points=32)
    os.makedirs(j.data_dir(), exist_ok=True)
    j.save()
    p = P.SceneDataset("synthetic", for_training=True, device=CPU)
    p.name = "not_synthetic"                    # load the pickles, not the in-memory scene
    assert p.load()
    _assert_scenes_equal(j, p)
    assert len(p.records) == 16

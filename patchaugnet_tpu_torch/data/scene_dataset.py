"""Scene dataset: submap records, pos/neg tuples, descriptor store.

Port of ``patchaugnet_tpu/data/scene_dataset.py`` (the reference's
``datasets/scene_dataset.py``). One scene = several "trips" of submaps.
Responsibilities kept:

  - ``create``: walk trip dirs, read ``{submap_type}.csv`` of
    (timestamp, northing, easting) with the ``csv`` module, sorted by
    timestamp, carve train/test by region boxes, radius search on
    ``scipy.spatial.cKDTree`` -> positive/negative tuples per
    (query_trip, ref_trip), pickle everything (scene_dataset.py:299-426).
  - ``load`` from pickles (:428-471): the port's own, whose records are a
    dict of columns, and those of the JAX package and the reference,
    whose records are a pandas DataFrame (read only where pandas is
    installed, and converted on load).
  - ``get_tuple`` merged across ref trips (:150-174).
  - training-tuple assembly with hard-negative mining
    (:473-492, 1124-1247) — mining runs on the dataset's device
    (data/retrieval.py) instead of per-query sklearn KDTrees.
  - ``make_descs``: batched whole-database embedding with optional
    wall-clock stats (:494-711), fed fixed-size batches.
  - recall/precision per (query_trip, ref_trip) via the retrieval engine
    with reference-exact bookkeeping (:1016-1099).
  - ``get_fpfh[s]``: FPFH features of a record's raw cloud (:mod:`.fpfh`,
    float64 on the host), FIFO cached (:756-786).

The records are a :class:`Records` column table (numpy), not a pandas
DataFrame. A scene that is not self-collected and stores float64 clouds
reads them through the native batch reader (:mod:`.fast_loader`, built
from ``csrc/fast_loader.cc``), as the JAX package does where that library
builds; here a build that fails raises, and ``native_loader = False``
chooses the numpy route. The two give the same bits where the global
offset is 0, as in every registered dataset that takes this route (the
native reader rounds to float32 before the offset is subtracted, as in
the JAX package). The synthetic scene
(``name='synthetic'``) is generated in memory so CI and smoke runs need no
data on disk.
"""
from __future__ import annotations

import csv
import os
import pickle
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..utils.timestamps import timestamp2str
from . import fpfh as fpfh_mod
from . import retrieval
from .dataset_info import get_dataset_info
from .pointclouds import load_pc_file, normalize_point_cloud


@dataclass
class QueryPosNegTuple:
    """Positive/negative dataset-global indices for one query.

    Field names match the reference class (scene_dataset.py:21-24) so
    reference pickles map onto it directly.
    """

    positive_indices: List[int] = field(default_factory=list)
    negative_indices: List[int] = field(default_factory=list)


class Records:
    """The submap records, one row per submap in dataset order, as a column
    table: ``file`` (a list of str), ``northing`` and ``easting`` (float64
    arrays). The JAX package keeps a pandas DataFrame with these columns."""

    columns = ("file", "northing", "easting")

    def __init__(self, file: Iterable[str] = (), northing=(), easting=()):
        self.file = [str(f) for f in file]
        self.northing = np.asarray(northing, np.float64).reshape(-1)
        self.easting = np.asarray(easting, np.float64).reshape(-1)
        if not len(self.file) == len(self.northing) == len(self.easting):
            raise ValueError("records: the columns differ in length")

    def __len__(self) -> int:
        return len(self.file)

    def xy(self, first: str = "northing", second: str = "easting") -> np.ndarray:
        """``(n, 2)`` float64 of two coordinate columns, in the order named."""
        return np.stack([getattr(self, first), getattr(self, second)], axis=-1)

    def select(self, keep: Sequence[bool]) -> "Records":
        keep = np.asarray(keep, bool).reshape(-1)
        return Records([f for f, k in zip(self.file, keep) if k], self.northing[keep], self.easting[keep])

    @staticmethod
    def concat(parts: Sequence["Records"]) -> "Records":
        return Records([f for p in parts for f in p.file],
                       np.concatenate([p.northing for p in parts] or [np.zeros(0)]),
                       np.concatenate([p.easting for p in parts] or [np.zeros(0)]))

    def to_dict(self) -> Dict:
        """The columns as a plain dict (what the port's pickles hold)."""
        return {"file": list(self.file), "northing": self.northing.copy(), "easting": self.easting.copy()}

    @staticmethod
    def from_pickled(obj) -> "Records":
        """The port's dict of columns, or the DataFrame of a JAX-package or
        reference pickle."""
        if isinstance(obj, dict):
            return Records(obj["file"], obj["northing"], obj["easting"])
        return Records(obj["file"].tolist(), obj["northing"].to_numpy(np.float64),
                       obj["easting"].to_numpy(np.float64))


def _host(x) -> np.ndarray:
    """A forward's output (a tensor on any device, or an array) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _read_trip_csv(path: str) -> Tuple[List, np.ndarray, np.ndarray]:
    """(timestamps, northing, easting) of a trip CSV, sorted by timestamp as
    ``pd.read_csv(path).sort_values("timestamp")`` sorts them: an all-integer
    column is int64 (else float64), ordered by numpy's default argsort.
    Coordinates parse with Python's ``float``, correctly rounded; pandas'
    default parser gives the same doubles for up to 15 significant digits
    (the benchmark CSVs hold 12 or 13) and may differ by an ulp past that."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f, skipinitialspace=True))
    raw = [r["timestamp"].strip() for r in rows]
    try:
        stamps = np.array([int(t) for t in raw], np.int64)
    except ValueError:
        stamps = np.array([float(t) for t in raw], np.float64)
    order = np.argsort(stamps, kind="quicksort")
    northing = np.array([float(r["northing"]) for r in rows], np.float64)
    easting = np.array([float(r["easting"]) for r in rows], np.float64)
    return stamps[order].tolist(), northing[order], easting[order]


class _BoundedCache:
    """Size-bounded FIFO cache (the reference's deque caches,
    scene_dataset.py:51-55): one implementation for the cloud /
    global-desc / local-desc caches instead of three hand-rolled
    evict loops. ``size_fn`` is read at insert time so a runtime
    ``cache_size`` change takes effect immediately."""

    def __init__(self, size_fn: Callable[[], int]):
        self._size_fn = size_fn
        self._d: Dict = {}
        self._order: deque = deque()

    def __contains__(self, key) -> bool:
        return key in self._d

    def __getitem__(self, key):
        return self._d[key]

    def __len__(self) -> int:
        return len(self._d)

    def put(self, key, value) -> None:
        if key not in self._d:
            self._order.append(key)
        self._d[key] = value
        while len(self._order) > self._size_fn():
            self._d.pop(self._order.popleft(), None)

    def clear(self) -> None:
        self._d.clear()
        self._order.clear()


class _CompatUnpickler(pickle.Unpickler):
    """Loads the port's pickles and those of the JAX package and the
    reference: any ``QueryPosNegTuple`` class maps to the port's; a
    DataFrame of records needs pandas."""

    def find_class(self, module, name):
        if name == "QueryPosNegTuple":
            return QueryPosNegTuple
        if module.split(".")[0] == "pandas":
            try:
                import pandas  # noqa: F401
            except ImportError:
                raise ImportError("these dataset pickles hold a pandas DataFrame (written by the JAX "
                                  "package or the reference); reading them needs pandas, which is not "
                                  "installed. Re-create the dataset with create_dataset_torch.py") from None
        return super().find_class(module, name)


def _check_in_test_region(northing, easting, points, x_width, y_width) -> bool:
    for p in points:
        if p[0] - x_width < northing < p[0] + x_width and p[1] - y_width < easting < p[1] + y_width:
            return True
    return False


class SceneDataset:
    """One scene (all trips), its tuples, and its descriptor store.

    ``device``: where the retrieval engine runs (the card unless the caller
    asks for the CPU); creating and loading a scene needs no device.
    ``native_loader``: whether a file-backed scene of float64 clouds that
    is not self-collected reads them with :mod:`.fast_loader` (set it
    False, on the class or an instance, for the numpy route)."""

    native_loader = True

    def __init__(self, name: str, for_training: bool, device: Union[str, torch.device] = "cuda"):
        self.name = name
        self.device = device
        info = get_dataset_info(name)
        self.data_cfg = info.train_cfg() if for_training else info.test_cfg()
        self.submap_type = self.data_cfg["submap_type"]
        prefix = "test_" if self.data_cfg["is_test_dataset"] else "train_"
        self.dataset_type = prefix + self.submap_type
        self.num_points = self.data_cfg.get("num_points", 4096)

        self.trip_names: List[str] = []
        self.records = Records()
        self.records_size_list: List[int] = []
        self.valid_indices_list: List[Set[int]] = []
        # (q_trip, r_trip) -> {q_idx_in_dataset: QueryPosNegTuple}
        self.tuples: Dict[Tuple[int, int], Dict[int, QueryPosNegTuple]] = {}
        self.global_descs: Optional[np.ndarray] = None
        self.hard_negative_indices: Dict[int, List[int]] = {}
        # in-memory cloud store for the synthetic scene
        self._clouds: Optional[np.ndarray] = None
        # in-memory overlap correspondences: (q_idx, p_idx) -> list of
        # (idx1, near2[list], far2[list], bad_far2[list])
        self.overlap_store: Dict[Tuple[int, int], List] = {}
        # size-bounded FIFO caches, reference scene_dataset.py:51-55
        # (desc caches key on (model_type, idx) — two model types on one
        # dataset must not serve each other's vectors). The *_order
        # aliases expose the FIFO deques for tests/diagnostics.
        self.cache_size = 1000
        self._pc_cache = _BoundedCache(lambda: self.cache_size)
        self._pc_order = self._pc_cache._order
        self._g_desc_cache = _BoundedCache(lambda: self.cache_size)
        self._g_order = self._g_desc_cache._order
        # local kpt/desc cache for the rerank pipeline (:810-841)
        self._l_cache = _BoundedCache(lambda: self.cache_size)
        self._l_order = self._l_cache._order
        # FPFH cache (reference fpfh_dict, scene_dataset.py:52-55), keyed on
        # (idx, radius_normal, radius_feature)
        self._fpfh_cache = _BoundedCache(lambda: self.cache_size)
        # model types whose on-disk store THIS process wrote (make_descs
        # with save_model_type): only those stores are safe to reload in
        # place of the in-memory descriptors
        self._stores_written: Set[str] = set()

    # ------------------------------------------------------------- misc
    def __len__(self) -> int:
        return len(self.records)

    def data_dir(self) -> str:
        return self.data_cfg["data_dir"]

    def pickle_dir(self) -> str:
        return os.path.join(self.data_dir(), "pickle_data")

    def trip_indices(self) -> List[List[int]]:
        out, s = [], 0
        for n in self.records_size_list:
            out.append(list(range(s, s + n)))
            s += n
        return out

    def trip_of(self, idx: int) -> Tuple[int, int]:
        s = 0
        for t, n in enumerate(self.records_size_list):
            if s <= idx < s + n:
                return t, idx - s
            s += n
        return -1, -1

    def _reset(self) -> None:
        self.trip_names = []
        self.records = Records()
        self.records_size_list = []
        self.valid_indices_list = []
        self.tuples = {}
        self.global_descs = None
        self.hard_negative_indices = {}
        self._clouds = None
        self._pc_cache.clear()
        self._g_desc_cache.clear()
        self._l_cache.clear()
        self._fpfh_cache.clear()
        self._stores_written = set()

    # ----------------------------------------------------------- create
    def create(self, max_neg: int = 10000, save: bool = True, rng: Optional[random.Random] = None) -> None:
        """Build records + tuples from trip CSVs (reference create()).
        ``rng`` draws ``max_neg`` negatives of a query that has more (the
        global ``random`` when not given, as in the JAX package)."""
        self._reset()
        cfg = self.data_cfg
        trip_dirs = sorted(
            d
            for d in os.listdir(self.data_dir())
            if os.path.isdir(os.path.join(self.data_dir(), d)) and "pickle_data" not in d
        )
        wanted = cfg["trip_names"]
        self.trip_names = (
            [t for t in wanted if t in trip_dirs] if isinstance(wanted, list) else trip_dirs
        )

        parts = []
        for trip in self.trip_names:
            stamps, northing, easting = _read_trip_csv(
                os.path.join(self.data_dir(), trip, self.submap_type + ".csv"))
            cloud_dir = os.path.join(self.data_dir(), trip, self.submap_type)
            tr = Records([os.path.join(cloud_dir, timestamp2str(ts) + cfg["cloud_ext"]) for ts in stamps],
                         northing, easting)
            if not cfg["is_test_dataset"]:
                tr = tr.select([
                    not _check_in_test_region(
                        n, e, cfg["test_region_vertices"],
                        cfg["test_region_width"], cfg["test_region_width"],
                    )
                    for n, e in zip(tr.northing, tr.easting)
                ])
            parts.append(tr)
            self.records_size_list.append(len(tr))
            self.valid_indices_list.append(set())
        self.records = Records.concat(parts)
        self._build_tuples(max_neg, rng)
        if save:
            self.save()

    def _build_tuples(self, max_neg: int, rng: Optional[random.Random] = None) -> None:
        rng = rng or random
        cfg = self.data_cfg
        xy = self.records.xy()
        from scipy.spatial import cKDTree   # imported here: scipy.spatial takes a second

        tree = cKDTree(xy)
        n_trips = len(self.trip_names)
        for qt in range(n_trips):
            for rt in range(n_trips):
                self.tuples[qt, rt] = {}
        all_indices = np.arange(len(self.records))
        for q_idx in range(len(self.records)):
            in_test = _check_in_test_region(
                xy[q_idx, 0], xy[q_idx, 1], cfg["test_region_vertices"],
                cfg["test_region_width"], cfg["test_region_width"],
            )
            if cfg["is_test_dataset"] ^ in_test:
                continue
            qt, _ = self.trip_of(q_idx)
            center = xy[q_idx]
            pos = np.setdiff1d(
                np.asarray(tree.query_ball_point(center, r=cfg["search_radius_pos"]), np.int64), [q_idx]
            ).tolist()
            near = np.asarray(tree.query_ball_point(center, r=cfg["search_radius_neg"]), np.int64)
            neg = np.setdiff1d(all_indices, near).tolist()
            if len(neg) > max_neg:
                neg = rng.sample(neg, max_neg)
            for p in pos:
                rt, _ = self.trip_of(p)
                self.tuples[qt, rt].setdefault(q_idx, QueryPosNegTuple()).positive_indices.append(p)
            for n in neg:
                rt, _ = self.trip_of(n)
                self.tuples[qt, rt].setdefault(q_idx, QueryPosNegTuple()).negative_indices.append(n)
            if pos and neg:
                self.valid_indices_list[qt].add(q_idx)

    def create_synthetic(
        self,
        n_trips: int = 2,
        n_per_trip: int = 24,
        num_points: Optional[int] = None,
        seed: int = 0,
    ) -> None:
        """In-memory scene: trips revisit the same route of "locations",
        each location contributing a close pair of submaps, so every
        query has several true positives (pair partner + cross-trip
        revisits within ``search_radius_pos``) and far locations supply
        negatives beyond ``search_radius_neg``."""
        self._reset()
        num_points = num_points or self.num_points
        rng = np.random.RandomState(seed)
        self.trip_names = [f"trip_{i}" for i in range(n_trips)]
        # test split lives inside the registry's test-region box
        region_offset = 10000.0 if self.data_cfg["is_test_dataset"] else 0.0
        n_loc = max(n_per_trip // 2, 1)
        loc_spacing, pair_offset = 25.0, 5.0
        # one latent "place geometry" per location (pair shares it)
        base_clouds = rng.rand(n_loc, num_points, 3).astype(np.float32) * 2 - 1
        rows, clouds = [], []
        for t in range(n_trips):
            count = 0
            for i in range(n_per_trip):
                loc = i // 2
                rows.append(
                    {
                        "file": f"synthetic://{t}/{i}",
                        "northing": region_offset + loc * loc_spacing
                        + (i % 2) * pair_offset + rng.randn() * 0.5,
                        "easting": rng.randn() * 0.5,
                    }
                )
                cloud = base_clouds[loc] + rng.randn(num_points, 3).astype(np.float32) * 0.02
                clouds.append(cloud)
                count += 1
            self.records_size_list.append(count)
            self.valid_indices_list.append(set())
        self.records = Records([r["file"] for r in rows], [r["northing"] for r in rows],
                               [r["easting"] for r in rows])
        self._clouds = np.stack(clouds)
        self._build_tuples(max_neg=10000)

    # ------------------------------------------------------------ io
    def save(self) -> None:
        pdir = self.pickle_dir()
        os.makedirs(pdir, exist_ok=True)
        for (qt, rt), d in self.tuples.items():
            if not d:
                continue
            path = os.path.join(pdir, f"{self.dataset_type}_tuples_{qt}_to_{rt}.pickle")
            with open(path, "wb") as f:
                pickle.dump(d, f, protocol=pickle.HIGHEST_PROTOCOL)
        path = os.path.join(pdir, f"{self.dataset_type}_records.pickle")
        with open(path, "wb") as f:
            pickle.dump(
                (self.trip_names, self.records.to_dict(), self.records_size_list, self.valid_indices_list),
                f,
                protocol=pickle.HIGHEST_PROTOCOL,
            )

    def load(self) -> bool:
        """Load records + all tuple pickles (the port's, the JAX package's
        or the reference's; the latter two need pandas)."""
        if self.name == "synthetic":
            if len(self.records) == 0:
                self.create_synthetic()
            return True
        pdir = self.pickle_dir()
        rec = os.path.join(pdir, f"{self.dataset_type}_records.pickle")
        if not os.path.exists(rec):
            return False
        with open(rec, "rb") as f:
            (self.trip_names, records, self.records_size_list,
             self.valid_indices_list) = _CompatUnpickler(f).load()
        self.records = Records.from_pickled(records)
        n = len(self.trip_names)
        for qt in range(n):
            for rt in range(n):
                path = os.path.join(pdir, f"{self.dataset_type}_tuples_{qt}_to_{rt}.pickle")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        self.tuples[qt, rt] = _CompatUnpickler(f).load()
        return True

    # --------------------------------------------------------- tuples
    def get_tuple(
        self, q_idx: int, ref_trip_idx: int = -1, skip_trip_itself: bool = False
    ) -> QueryPosNegTuple:
        qt, _ = self.trip_of(q_idx)
        out = QueryPosNegTuple()
        trips = (
            range(len(self.trip_names)) if ref_trip_idx == -1 else [ref_trip_idx]
        )
        for rt in trips:
            if qt == rt and skip_trip_itself:
                continue
            d = self.tuples.get((qt, rt))
            if d and q_idx in d:
                out.positive_indices += d[q_idx].positive_indices
                out.negative_indices += d[q_idx].negative_indices
        return out

    def true_positives_for(
        self, query_indices: Sequence[int], ref_trip_idx: int, skip_trip_itself: bool
    ) -> Dict[int, Set[int]]:
        return {
            q: set(self.get_tuple(q, ref_trip_idx, skip_trip_itself).positive_indices)
            for q in query_indices
        }

    # --------------------------------------------------------- clouds
    def _load_raw_clouds(self, indices: Sequence[int]) -> List[np.ndarray]:
        """Raw clouds with the registry global offset applied (the
        reference subtracts it on every load, scene_dataset.py:722)."""
        offset = np.asarray(self.data_cfg.get("global_offset", 0.0))
        if self._clouds is not None:
            return [self._clouds[i] - offset for i in indices]
        files = [self.records.file[i] for i in indices]
        if self.native_loader and not self.data_cfg["self_collected"] and self.data_cfg["cloud_dtype"] == np.float64:
            from . import fast_loader

            clouds, _, _ = fast_loader.load_clouds(files, self.num_points, normalize=False)
            return [c - offset for c in clouds]
        return [
            load_pc_file(
                f, dtype=self.data_cfg["cloud_dtype"],
                use_np_load=self.data_cfg["self_collected"],
            ) - offset
            for f in files
        ]

    def get_clouds(
        self, indices: Sequence[int], normalize: bool = True
    ) -> Tuple[np.ndarray, List[Dict]]:
        """Load + (optionally) normalise clouds for dataset-global indices.

        Per-record results are kept in a size-bounded FIFO cache
        (reference get_pc/pc_dict, scene_dataset.py:713-741) so repeat
        epochs over a file-backed scene skip the disk reads; unlike the
        reference, the cache key includes the processing flags so a hit
        can never return a differently-normalised cloud.
        """
        normalize = normalize and self.data_cfg["self_collected"]
        key = (normalize,)
        ready = {
            i: self._pc_cache[i][1:]
            for i in indices
            if i in self._pc_cache and self._pc_cache[i][0] == key
        }
        missing = [i for i in indices if i not in ready]
        if missing:
            raw = self._load_raw_clouds(missing)
            for i, pc in zip(missing, raw):
                meta = {"scale": 1.0, "trans": np.zeros([1, 3])}
                if normalize:
                    pc, meta = normalize_point_cloud(pc, True)
                ready[i] = (np.asarray(pc, np.float32), meta)
                self._pc_cache.put(i, (key,) + ready[i])
        pcs = [ready[i][0] for i in indices]
        metas = [ready[i][1] for i in indices]
        return np.asarray(pcs, np.float32), metas

    def get_fpfh(
        self,
        idx: int,
        radius_normal: float = 0.05,
        radius_feature: float = 0.05,
    ) -> np.ndarray:
        """``(N, 33)`` float64 FPFH features of one record's raw cloud, FIFO
        cached (reference get_fpfh, scene_dataset.py:756-780 — open3d
        there, :mod:`.fpfh` here; the same radii defaults, the raw
        un-normalised cloud like the reference's ``get_pc(idx)``)."""
        ck = (idx, radius_normal, radius_feature)
        if ck not in self._fpfh_cache:
            pc, _ = self.get_clouds([idx], normalize=False)
            self._fpfh_cache.put(ck, fpfh_mod.compute_fpfh(pc[0], radius_normal, radius_feature))
        return self._fpfh_cache[ck]

    def get_fpfhs(
        self,
        idxs: Sequence[int],
        radius_normal: float = 0.05,
        radius_feature: float = 0.05,
    ) -> List[np.ndarray]:
        """Reference get_fpfhs (scene_dataset.py:782-786)."""
        return [self.get_fpfh(i, radius_normal, radius_feature) for i in idxs]

    def get_training_tuple(
        self,
        q_idx: int,
        num_pos: int,
        num_neg: int,
        other_neg: bool = True,
        rng: Optional[random.Random] = None,
        load: bool = True,
    ) -> Optional[Dict]:
        """Sample a (query, positives, negatives, other_neg) tuple.

        Returns None for faulty tuples (insufficient pos/neg or missing
        other_neg — the reference *skips* those batches,
        train_place_recognition.py:223-256). ``load=False`` draws the same
        tuple and leaves its clouds and metas unloaded (None).
        """
        rng = rng or random
        t = self.get_tuple(q_idx, -1, self.data_cfg["skip_trip_itself"])
        if len(t.positive_indices) < num_pos or len(t.negative_indices) < num_neg:
            return None
        pos = rng.sample(t.positive_indices, num_pos)
        hard = self.hard_negative_indices.get(q_idx, [])
        neg = rng.sample(hard, num_neg) if len(hard) >= num_neg else list(hard)
        while len(neg) < num_neg:
            c = rng.choice(t.negative_indices)
            if c not in neg:
                neg.append(c)
        o_idx = None
        if other_neg:
            neighbors = set(t.positive_indices)
            for n in neg:
                neighbors |= set(
                    self.get_tuple(n, -1, self.data_cfg["skip_trip_itself"]).positive_indices
                )
            candidates = list(set(range(len(self.records))) - neighbors)
            if not candidates:
                return None
            o_idx = rng.choice(candidates)
        indices = [q_idx] + pos + neg + ([o_idx] if o_idx is not None else [])
        clouds, metas = self.get_clouds(indices) if load else (None, None)
        return {
            "indices": ([q_idx], pos, neg, [o_idx] if o_idx is not None else []),
            "clouds": clouds,            # (1+P+N+1, num_points, 3)
            "norm_meta": metas,
        }

    # ------------------------------------------------- hard negatives
    def mine_hard_negatives(
        self, num_hard_neg: int = 10, num_sample_neg: int = 3000,
        *, rng: np.random.RandomState,
    ) -> None:
        """Refresh the hard-negative cache from current global_descs
        (scene_dataset.py:473-492 inlined per __getitem__; here
        ``ceil(Q/1024)`` fixed-shape sweeps on the dataset's device via
        ``retrieval.hard_negatives_batch``). ``rng`` draws
        ``num_sample_neg`` candidates of a query that has more (the JAX
        package draws from the global ``np.random``)."""
        if self.global_descs is None:
            return
        q_indices: List[int] = []
        neg_lists: List[List[int]] = []
        for q_idx in range(len(self.records)):
            t = self.get_tuple(q_idx, -1, self.data_cfg["skip_trip_itself"])
            negs = t.negative_indices
            if not negs:
                continue
            if len(negs) > num_sample_neg:
                negs = list(rng.choice(negs, num_sample_neg, replace=False))
            q_indices.append(q_idx)
            neg_lists.append(list(negs))
        if not q_indices:
            return
        mined = retrieval.hard_negatives_batch(
            self.global_descs[np.asarray(q_indices)],
            self.global_descs,
            neg_lists,
            num_hard_neg,
            device=self.device,
        )
        for q_idx, hard in zip(q_indices, mined):
            self.hard_negative_indices[q_idx] = hard

    # ------------------------------------------------------ descriptors
    def desc_dir(self, model_type: str) -> str:
        """Reference descriptor-dump layout (scene_dataset.py:104-111)."""
        extra = "test" if self.data_cfg["is_test_dataset"] else "train"
        return os.path.join(self.pickle_dir(), f"desc_{model_type}_{extra}")

    def g_desc_dir(self, model_type: str) -> str:
        return os.path.join(self.desc_dir(model_type), "global")

    def l_desc_dir(self, model_type: str) -> str:
        return os.path.join(self.desc_dir(model_type), "local")

    def euc_knn_dir(self) -> str:
        return os.path.join(self.pickle_dir(), "euc_knn")

    def get_g_desc(self, model_type: str, idx: int) -> np.ndarray:
        """Load one stored (1, C) global descriptor (cached,
        reference get_g_desc, scene_dataset.py:788-804)."""
        ck = (model_type, idx)
        if ck not in self._g_desc_cache:
            path = os.path.join(self.g_desc_dir(model_type), f"{idx}.pickle")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"descriptor store incomplete: {path} is missing "
                    f"(records={len(self.records)}); re-run make_descs "
                    f"with save_model_type={model_type!r}"
                )
            with open(path, "rb") as f:
                self._g_desc_cache.put(ck, pickle.load(f))
        return self._g_desc_cache[ck]

    def get_g_descs(self, model_type: str, idxs: Sequence[int]) -> List[np.ndarray]:
        return [self.get_g_desc(model_type, i) for i in idxs]

    def get_l_kpt_desc(
        self, model_type: str, idx: int, unify_coord: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Load one record's local keypoints + descriptors (cached,
        reference get_l_kpt_desc, scene_dataset.py:808-841).

        unify_coord de-normalises the keypoints into the scene frame:
        ``kpt * scale + (trans - global_offset)``.
        """
        ck = (model_type, idx)
        if ck not in self._l_cache:
            path = os.path.join(self.l_desc_dir(model_type), f"{idx}.pickle")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"local-descriptor store incomplete: {path} is missing "
                    f"(records={len(self.records)}); re-run make_descs "
                    f"with save_model_type={model_type!r}"
                )
            with open(path, "rb") as f:
                l_kpt, l_desc, norm_meta = pickle.load(f)
            k = np.asarray(l_kpt, np.float64).reshape(len(l_kpt), -1)
            self._l_cache.put(
                ck, (k, np.asarray(l_desc).reshape(len(l_desc), -1), norm_meta)
            )
        kpt, desc, meta = self._l_cache[ck]
        if unify_coord:
            trans = np.asarray(meta["trans"]).reshape(1, -1)
            trans = trans - np.asarray(self.data_cfg.get("global_offset", 0.0)).reshape(1, -1)[:, : trans.shape[1]]
            kpt = kpt * meta["scale"] + trans
        return kpt, desc

    def get_l_kpts_descs(
        self, model_type: str, idxs: Sequence[int], unify_coord: bool = False
    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        kpts, descs = [], []
        for i in idxs:
            k, d = self.get_l_kpt_desc(model_type, i, unify_coord)
            kpts.append(k)
            descs.append(d)
        return kpts, descs

    def make_descs(
        self,
        forward_fn: Callable[[np.ndarray], np.ndarray],
        batch_size: int = 100,
        stat_time: bool = False,
        save_model_type: Optional[str] = None,
        rows: Optional[slice] = None,
    ) -> Optional[Dict[str, float]]:
        """Embed the whole database.

        ``forward_fn``: ``(B, N, 3) -> (B, D)`` (tensors on any device, or
        arrays), or, for models exposing local descriptors, ``-> (global
        (B, D), local (B, K, C), center_idx (B, K))`` — the reference's
        tuple-returning forward (scene_dataset.py:676-679). The last
        partial batch is padded to ``batch_size`` (one shape for the whole
        sweep, as in the JAX package).

        With ``save_model_type``, the per-record store is written in the
        reference layout (scene_dataset.py:687-708): ``global/<i>.pickle``
        holds the (1, C) global descriptor; when locals are available,
        ``local/<i>.pickle`` holds ``(l_pos (K, 3), l_desc (K, C),
        norm_meta)`` with l_pos = the (normalised) input cloud gathered
        at the level-1 centre indices.

        ``rows``: load only those rows of each (padded) batch, and
        ``forward_fn`` returns the whole batch's outputs from them (a
        sharded forward, one rank's rows in); no store is written then.
        """
        if rows is not None and save_model_type is not None:
            raise ValueError("the local store needs each batch's clouds whole: save_model_type with rows=None")
        n = len(self.records)
        descs = []
        times = []
        g_dir = l_dir = None
        if save_model_type is not None:
            g_dir = self.g_desc_dir(save_model_type)
            os.makedirs(g_dir, exist_ok=True)
            l_dir = self.l_desc_dir(save_model_type)
            os.makedirs(l_dir, exist_ok=True)
        # double-buffered: enqueue batch i+1 before fetching batch i so
        # host IO overlaps device compute (the reference synchronises
        # per batch, scene_dataset.py:666-686); the clouds' copy to the
        # card waits for the previous batch's forward
        pending = None    # (device_out, idx, clouds, metas, t_enqueue)
        starts = list(range(0, n, batch_size))
        for bi, s in enumerate(starts + [None]):
            if s is not None:
                idx = list(range(s, min(s + batch_size, n)))
                pad = batch_size - len(idx)
                if rows is not None:
                    clouds, metas = self.get_clouds((idx + idx[-1:] * pad)[rows])
                else:
                    clouds, metas = self.get_clouds(idx)
                    if pad:
                        clouds = np.concatenate(
                            [clouds, np.repeat(clouds[-1:], pad, 0)]
                        )
                t0 = time.perf_counter()
                handle = forward_fn(clouds)
            else:
                handle = None
            if pending is not None:
                p_handle, p_idx, p_clouds, p_metas, p_t0 = pending
                locals_out = None
                if isinstance(p_handle, (tuple, list)):
                    g, l_desc, center_idx = p_handle
                    out = _host(g)[: len(p_idx)]
                    locals_out = (
                        _host(l_desc)[: len(p_idx)],
                        _host(center_idx)[: len(p_idx)],
                    )
                else:
                    out = _host(p_handle)[: len(p_idx)]
                if stat_time:
                    times.append((time.perf_counter() - p_t0) / batch_size)
                if g_dir is not None:
                    # per-record pickle of the (1, C) descriptor
                    # (scene_dataset.py:694-698)
                    for k, rec_idx in enumerate(p_idx):
                        with open(
                            os.path.join(g_dir, f"{rec_idx}.pickle"), "wb"
                        ) as f:
                            pickle.dump(out[k].reshape(1, -1), f,
                                        protocol=pickle.HIGHEST_PROTOCOL)
                        if locals_out is not None:
                            l_pos = p_clouds[k][locals_out[1][k]]  # (K, 3)
                            with open(
                                os.path.join(l_dir, f"{rec_idx}.pickle"), "wb"
                            ) as f:
                                pickle.dump(
                                    (l_pos, locals_out[0][k], p_metas[k]),
                                    f, protocol=pickle.HIGHEST_PROTOCOL,
                                )
                descs.append(out)
            pending = (handle, idx, clouds, metas, t0) if s is not None else None
        self.global_descs = np.concatenate(descs)
        if save_model_type is not None:
            self._stores_written.add(save_model_type)
            # both stores were rewritten: cached reads of either would
            # serve the previous checkpoint's descriptors
            self._g_desc_cache.clear()
            self._l_cache.clear()
        if stat_time and times:
            # skip the first (compile) batch like the reference skips
            # warm-up noise in its mean/std report
            t = np.array(times[1:] or times) * 1000
            return {"mean_ms": float(t.mean()), "std_ms": float(t.std())}
        return None

    def clear_global_descs(self) -> None:
        self.global_descs = None

    # ---------------------------------------------------------- recall
    def recall_precision_all(
        self, top_k: int = 25, collect_query_results: bool = False
    ) -> Dict[Tuple[int, int], retrieval.RecallResult]:
        """Per-(query_trip, ref_trip) recall/precision, the neighbour search
        on the dataset's device (PlaceRecognitionDataSet.get_recall_precision,
        place_recognition_dataset.py:52-70)."""
        assert self.global_descs is not None, "run make_descs first"
        skip = self.data_cfg["skip_trip_itself"]
        test_query_trips = self.data_cfg["test_query_trips"]
        sample_indices = self.trip_indices()
        out = {}
        for rt in range(len(self.trip_names)):
            db_idx = sample_indices[rt]
            db_descs = self.global_descs[db_idx]
            for qt in range(len(self.trip_names)):
                if skip and qt == rt:
                    continue
                if test_query_trips is not None and self.trip_names[qt] not in test_query_trips:
                    continue
                q_idx = sample_indices[qt]
                res = retrieval.recall_precision(
                    self.global_descs[q_idx],
                    db_descs,
                    db_idx,
                    q_idx,
                    self.true_positives_for(q_idx, rt, skip),
                    top_k=top_k,
                    add_one_more=(qt == rt) and not skip,
                    collect_query_results=collect_query_results,
                    device=self.device,
                )
                out[qt, rt] = res
        return out

    def print_stat_info(self) -> Dict[str, float]:
        """Dataset statistics report (reference print_stat_info,
        scene_dataset.py:66-97): trip pairs, avg queries/maps per pair,
        avg positives per query."""
        is_test = self.data_cfg["is_test_dataset"]
        test_query_trips = self.data_cfg["test_query_trips"]
        sample_indices = self.trip_indices()
        n_trip_pair = n_query = n_map = n_pos = 0
        for rt in range(len(self.trip_names)):
            for qt in range(len(self.trip_names)):
                if test_query_trips is not None and self.trip_names[qt] not in test_query_trips:
                    continue
                if is_test and qt == rt:
                    continue
                n_trip_pair += 1
                n_map += len(sample_indices[rt])
                for q in sample_indices[qt]:
                    tp = self.get_tuple(q, rt, is_test).positive_indices
                    if tp:
                        n_query += 1
                        n_pos += len(tp)
        if n_query:
            n_pos /= n_query
        if n_trip_pair:
            n_query /= n_trip_pair
            n_map /= n_trip_pair
        stats = {
            "n_trip_pair": n_trip_pair,
            "n_query": n_query,
            "n_map": n_map,
            "n_pos_per_query": n_pos,
        }
        print(
            f"n_trip_pair: {n_trip_pair}, n_query: {n_query}, "
            f"n_map: {n_map}, n_pos_per_query: {n_pos}"
        )
        return stats

    def get_dist(self, i: int, j: int) -> float:
        """Planar (northing, easting) distance between two records."""
        r = self.records
        return float(np.hypot(r.northing[i] - r.northing[j], r.easting[i] - r.easting[j]))

    def _basename_extra(self) -> str:
        return "test" if self.data_cfg["is_test_dataset"] else "train"

    def _ensure_global_descs(self, model_type: Optional[str]) -> None:
        """The reference reloads descriptors from the store before a
        top-k dump (scene_dataset.py:874-876) — safe there because its
        eval flow always writes the store first. Here the store may be
        stale (a previous run's checkpoint, ``--no_save_descs``, the
        sharded eval path): reload only when this process wrote it, or
        when there is no in-memory matrix to prefer."""
        store_ok = model_type is not None and os.path.isdir(
            self.g_desc_dir(model_type)
        )
        if store_ok and (
            model_type in self._stores_written or self.global_descs is None
        ):
            self.global_descs = np.concatenate(
                self.get_g_descs(model_type, list(range(len(self.records))))
            )
        assert self.global_descs is not None, "run make_descs first"

    def find_top_k_feat_train(self, top_k: int = 300) -> Dict[int, Dict]:
        """Training-mode top-k dump for rerank training
        (scene_dataset.py:884-925): labelled candidate lists per query —
        up to top_k/2 positives (state 1, within search_radius_pos) and
        top_k/2 negatives (state 0, beyond search_radius_neg), unknowns
        skipped, queries lacking both classes dropped."""
        assert self.global_descs is not None
        pos_xy = self.records.xy("easting", "northing").astype(np.float32)
        r_pos = self.data_cfg["search_radius_pos"]
        r_neg = self.data_cfg["search_radius_neg"]
        k = min(1000, len(self.records))
        _, nbr = retrieval.topk_neighbors(self.global_descs, self.global_descs, k, device=self.device)
        out: Dict[int, Dict] = {}
        for i in range(len(self.records)):
            top_list, states = [], []
            n_p = n_n = 0
            for j in nbr[i]:
                j = int(j)
                if j == i:
                    continue
                dist = float(np.linalg.norm(pos_xy[i] - pos_xy[j]))
                if dist < r_pos:
                    if n_p == top_k // 2:
                        continue
                    top_list.append(j)
                    states.append(1)
                    n_p += 1
                elif dist > r_neg:
                    if n_n == top_k // 2:
                        continue
                    top_list.append(j)
                    states.append(0)
                    n_n += 1
                if n_p + n_n == top_k:
                    break
            if n_p and n_n:
                out[i] = {"top_k": top_list, "state": states}
        return out

    def _find_top_k_feat_test(self, top_k: int = 300) -> Dict[Tuple[int, int], Dict]:
        """Test-mode top-k dump (scene_dataset.py:927-971): per
        (query_trip, ref_trip) pair, the full ranked top-k per query with
        geometric state labels (1 pos / 0 neg / -1 unknown); queries
        without true positives skipped."""
        assert self.global_descs is not None
        r_pos = self.data_cfg["search_radius_pos"]
        r_neg = self.data_cfg["search_radius_neg"]
        test_query_trips = self.data_cfg["test_query_trips"]
        sample_indices = self.trip_indices()
        out: Dict[Tuple[int, int], Dict] = {}
        for rt in range(len(self.trip_names)):
            db_idx = np.asarray(sample_indices[rt])
            if len(db_idx) == 0:
                continue
            real_k = min(top_k, len(db_idx))
            for qt in range(len(self.trip_names)):
                if test_query_trips is not None and (
                    self.trip_names[qt] not in test_query_trips
                ):
                    continue
                if qt == rt:
                    continue
                q_idx = sample_indices[qt]
                _, nbr = retrieval.topk_neighbors(
                    self.global_descs[q_idx], self.global_descs[db_idx], real_k, device=self.device
                )
                top_k_dict: Dict[int, Dict] = {}
                for qi, q in enumerate(q_idx):
                    t = self.get_tuple(q, rt, self.data_cfg["is_test_dataset"])
                    if not t.positive_indices:
                        continue  # may be outside the test region
                    entry = {"top_k": [], "state": []}
                    for j in nbr[qi]:
                        found = int(db_idx[int(j)])
                        dist = self.get_dist(q, found)
                        entry["top_k"].append(found)
                        entry["state"].append(
                            1 if dist < r_pos else (0 if dist > r_neg else -1)
                        )
                    top_k_dict[q] = entry
                out[qt, rt] = top_k_dict
        return out

    def find_top_k_feat(
        self,
        model_type: Optional[str] = None,
        top_k: int = 300,
        save: bool = False,
    ):
        """Feature-space top-k dump (scene_dataset.py:868-975): train
        mode returns one labelled dict; test mode one dict per
        (query_trip, ref_trip). With ``save`` (and ``model_type``) the
        pickles land in the reference layout under ``desc_dir``."""
        if len(self.records) == 0:                 # ref scene_dataset.py:871-872
            return None
        self._ensure_global_descs(model_type)
        extra = self._basename_extra()
        if not self.data_cfg["is_test_dataset"]:
            out = self.find_top_k_feat_train(top_k)
            if save and model_type is not None:
                d = self.desc_dir(model_type)
                os.makedirs(d, exist_ok=True)
                with open(
                    os.path.join(d, f"top_k_index_{extra}_init.pickle"), "wb"
                ) as f:
                    pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
            return out
        out = self._find_top_k_feat_test(top_k)
        if save and model_type is not None:
            d = self.desc_dir(model_type)
            os.makedirs(d, exist_ok=True)
            for (qt, rt), top_k_dict in out.items():
                path = os.path.join(
                    d, f"top_k_index_{extra}_{qt}_{rt}_init.pickle"
                )
                with open(path, "wb") as f:
                    pickle.dump(top_k_dict, f, protocol=pickle.HIGHEST_PROTOCOL)
        return out

    def find_top_k_euc(self, top_k: int = 300, save: bool = False):
        """Euclidean-position top-k dump (scene_dataset.py:977-1014).

        Train mode: one dict over all records, nearest top_k of the
        whole scene (skip self). Test mode: per ref trip, that trip's
        records ranked against their own trip (skip self) — keyed
        {ref_trip: {idx: {'euc_knn': ...}}}. Pickles land under
        ``euc_knn_dir`` with the reference names.
        """
        if len(self.records) == 0:
            return None
        pos = self.records.xy().astype(np.float32)
        extra = self._basename_extra()
        e_dir = self.euc_knn_dir()
        if save:
            os.makedirs(e_dir, exist_ok=True)
        if not self.data_cfg["is_test_dataset"]:
            k = min(top_k + 1, len(self.records))
            _, nbr = retrieval.topk_neighbors(pos, pos, k, device=self.device)
            out = {
                i: {"euc_knn": [int(j) for j in nbr[i] if int(j) != i][:top_k]}
                for i in range(len(self.records))
            }
            if save:
                with open(
                    os.path.join(e_dir, f"top_k_index_{extra}_init.pickle"), "wb"
                ) as f:
                    pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
            return out
        sample_indices = self.trip_indices()
        out: Dict[int, Dict] = {}
        for rt in range(len(self.trip_names)):
            db_idx = np.asarray(sample_indices[rt])
            if len(db_idx) == 0:
                continue
            k = min(top_k + 1, len(db_idx))
            _, nbr = retrieval.topk_neighbors(pos[db_idx], pos[db_idx], k, device=self.device)
            top_k_dict = {
                int(q): {
                    "euc_knn": np.asarray(
                        [int(db_idx[j]) for j in nbr[qi] if int(db_idx[j]) != int(q)][:top_k],
                        dtype=int,
                    )
                }
                for qi, q in enumerate(db_idx)
            }
            out[rt] = top_k_dict
            if save:
                path = os.path.join(
                    e_dir, f"top_k_index_{extra}_{rt}_init.pickle"
                )
                with open(path, "wb") as f:
                    pickle.dump(top_k_dict, f, protocol=pickle.HIGHEST_PROTOCOL)
        return out

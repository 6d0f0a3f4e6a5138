"""Dataset registry.

Port of ``patchaugnet_tpu/data/dataset_info.py`` (the reference's
``datasets/dataset_info.py:4-288``): the same per-dataset constants
(submap types, trip lists, test-region polygons, positive/negative
search radii, global offsets) for oxford / 3-Inhouse (university,
residential, business) / WHU (hankou, campus) / MulRan (sejong, dcc) /
KITTI-360, plus a ``synthetic`` dataset for CI and smoke runs.

Data roots resolve against the ``PCR_DATA_ROOT`` environment variable
(default ``./benchmark_datasets``). Datasets listed in the YAML file that
``PCR_EXTRA_DATASETS`` names are registered by :func:`get_dataset_info`
on the first lookup of a name the registry lacks (the JAX package
registers them when it is imported), so importing this module reads no
file and needs no PyYAML.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

DATA_ROOT_ENV = "PCR_DATA_ROOT"


def data_root() -> str:
    return os.environ.get(DATA_ROOT_ENV, "benchmark_datasets")


@dataclasses.dataclass
class DatasetInfo:
    name: str = ""
    self_collected: bool = False
    rel_dir: str = ""                       # relative to data_root()
    train_submap_type: str = ""
    test_submap_type: str = ""
    cloud_ext: str = ".bin"
    cloud_dtype: type = np.float64
    train_trip_names: Optional[List[str]] = None
    test_trip_names: Optional[List[str]] = None
    test_region_vertices: Sequence[Sequence[float]] = ()
    test_region_width: float = 0.0
    test_query_trips: Optional[List[str]] = None
    train_radius_pos: float = 0.0
    train_radius_neg: float = 0.0
    test_radius_pos: float = 0.0
    test_radius_neg: float = 0.0
    global_offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((1, 3))
    )
    num_points: int = 4096

    @property
    def data_dir(self) -> str:
        return os.path.join(data_root(), self.rel_dir)

    def _cfg(self, is_test: bool) -> Dict:
        return {
            "name": self.name,
            "is_test_dataset": is_test,
            "self_collected": self.self_collected,
            "data_dir": self.data_dir,
            "submap_type": self.test_submap_type if is_test else self.train_submap_type,
            "cloud_ext": self.cloud_ext,
            "cloud_dtype": self.cloud_dtype,
            "trip_names": self.test_trip_names if is_test else self.train_trip_names,
            "test_region_vertices": list(self.test_region_vertices),
            "test_region_width": self.test_region_width,
            "test_query_trips": self.test_query_trips if is_test else None,
            "search_radius_pos": self.test_radius_pos if is_test else self.train_radius_pos,
            "search_radius_neg": self.test_radius_neg if is_test else self.train_radius_neg,
            "skip_trip_itself": is_test,
            "global_offset": self.global_offset,
            "num_points": self.num_points,
        }

    def train_cfg(self) -> Dict:
        return self._cfg(False)

    def test_cfg(self) -> Dict:
        return self._cfg(True)


dataset_info_dict: Dict[str, DatasetInfo] = {}


def _register(info: DatasetInfo) -> DatasetInfo:
    dataset_info_dict[info.name] = info
    return info


OXFORD_TEST_TRIPS = [
    "2014-11-14-16-34-33", "2014-11-18-13-20-12", "2014-12-02-15-30-08",
    "2014-12-09-13-21-02", "2014-12-10-18-10-50", "2014-12-12-10-45-15",
    "2014-12-16-09-14-09", "2014-12-16-18-44-24", "2015-02-03-08-45-10",
    "2015-02-10-11-58-05", "2015-02-13-09-16-26", "2015-02-17-14-42-12",
    "2015-03-10-14-18-10", "2015-03-17-11-08-44", "2015-05-19-14-06-38",
    "2015-06-09-15-06-29", "2015-08-12-15-04-18", "2015-08-13-16-02-58",
    "2015-08-14-14-54-57", "2015-08-28-09-50-22", "2015-10-30-13-52-14",
    "2015-11-12-11-22-05", "2015-11-13-10-28-08",
]

_register(DatasetInfo(
    name="oxford", rel_dir="oxford",
    train_submap_type="pointcloud_20m_10overlap", test_submap_type="pointcloud_20m",
    test_trip_names=OXFORD_TEST_TRIPS,
    test_region_vertices=[
        [5735712.768124, 620084.402381], [5735611.299219, 620540.270327],
        [5735237.358209, 620543.094379], [5734749.303802, 619932.693364],
    ],
    test_region_width=150.0,
    train_radius_pos=10.0, train_radius_neg=50.0,
    test_radius_pos=25.0, test_radius_neg=50.0,
))

for _inhouse, _verts in {
    "university": [
        [363621.292362, 142864.19756], [364788.795462, 143125.746609],
        [363597.507711, 144011.414174],
    ],
    "residential": [
        [360895.486453, 144999.915143], [362357.024536, 144894.825301],
        [361368.907155, 145209.663042],
    ],
    "business": [[0.0, 0.0]],
}.items():
    _register(DatasetInfo(
        name=_inhouse, rel_dir=f"inhouse_datasets/{_inhouse}",
        train_submap_type="pointcloud_25m_25", test_submap_type="pointcloud_25m_25",
        test_region_vertices=_verts,
        test_region_width=1e10 if _inhouse == "business" else 150.0,
        train_radius_pos=12.5, train_radius_neg=50.0,
        test_radius_pos=25.0, test_radius_neg=50.0,
    ))

_register(DatasetInfo(
    name="hankou", self_collected=True, rel_dir="wh_hankou_origin",
    train_submap_type="pointcloud_30m_2m_clean", test_submap_type="pointcloud_30m_2m_clean",
    test_region_width=50.0, test_query_trips=["helmet_submap"],
    train_radius_pos=15.0, train_radius_neg=60.0,
    test_radius_pos=30.0, test_radius_neg=60.0,
    global_offset=np.array([[794000.0, 385000.0, 30.0]]),
))

_register(DatasetInfo(
    name="campus", self_collected=True, rel_dir="whu_campus_origin",
    train_submap_type="pointcloud_30m_2m_clean", test_submap_type="pointcloud_30m_2m_clean",
    test_region_vertices=[[0.0, 0.0]], test_region_width=1e10,
    test_query_trips=["helmet_submap"],
    train_radius_pos=15.0, train_radius_neg=60.0,
    test_radius_pos=30.0, test_radius_neg=60.0,
    global_offset=np.array([[534000.0, 3379000.0, 25.0]]),
))

_register(DatasetInfo(
    name="campus_rerank", self_collected=True, rel_dir="whu_campus_rerank",
    train_submap_type="pointcloud_30m_2m_clean", test_submap_type="pointcloud_30m_2m_clean",
    test_region_width=50.0, test_query_trips=["helmet_submap"],
    train_radius_pos=15.0, train_radius_neg=60.0,
    test_radius_pos=30.0, test_radius_neg=60.0,
))

_register(DatasetInfo(
    name="sejong", rel_dir="MulRan/TrainDataSejong01_02",
    train_submap_type="pointcloud_0.2m", test_submap_type="pointcloud_0.2m",
    cloud_dtype=np.float32, test_region_width=50.0,
    train_radius_pos=2.0, train_radius_neg=10.0,
    test_radius_pos=20.0, test_radius_neg=20.0,
))

for _n, _rel, _rpos in [
    ("dcc_20m", "MulRan/TestDataDCC01_02", 20.0),
    ("dcc_5m", "MulRan/TestDataDCC01_02_step5m", 5.0),
]:
    _register(DatasetInfo(
        name=_n, rel_dir=_rel,
        train_submap_type="pointcloud_10.0m", test_submap_type="pointcloud_10.0m",
        cloud_dtype=np.float32,
        test_region_vertices=[[0.0, 0.0]], test_region_width=1e10,
        test_query_trips=["query_seq1"],
        train_radius_pos=2.0, train_radius_neg=10.0,
        test_radius_pos=_rpos, test_radius_neg=20.0,
    ))

for _n, _rel, _rpos in [
    ("kitti360_20m", "KITTI_360/TestDataSeq09", 20.0),
    ("kitti360_5m", "KITTI_360/TestDataSeq09_step5m", 5.0),
]:
    _register(DatasetInfo(
        name=_n, rel_dir=_rel,
        train_submap_type="pointcloud_3.0m", test_submap_type="pointcloud_3.0m",
        cloud_dtype=np.float32,
        test_region_vertices=[[0.0, 0.0]], test_region_width=1e10,
        test_query_trips=["query_seq1"],
        train_radius_pos=2.0, train_radius_neg=10.0,
        test_radius_pos=_rpos, test_radius_neg=20.0,
    ))

# In-memory synthetic scene for CI / smoke runs (no files needed).
_register(DatasetInfo(
    name="synthetic", rel_dir="synthetic",
    train_submap_type="pointcloud_synth", test_submap_type="pointcloud_synth",
    # synthetic test split is generated at northing ~10000 (see
    # SceneDataset.create_synthetic), inside this region box
    test_region_vertices=[[10000.0, 0.0]], test_region_width=5000.0,
    train_radius_pos=10.0, train_radius_neg=50.0,
    test_radius_pos=25.0, test_radius_neg=50.0,
    num_points=4096,
))


# --------------------------------------------------- user-defined datasets
EXTRA_DATASETS_ENV = "PCR_EXTRA_DATASETS"


def load_extra_datasets(path: Optional[str] = None) -> List[str]:
    """Register datasets from a YAML file (list of DatasetInfo field
    dicts). The reference bakes every dataset into code with absolute
    paths (dataset_info.py:70,90,...); here new benchmarks are one YAML
    entry + the ``PCR_EXTRA_DATASETS`` env var — no code edits.

    Returns the registered names. :func:`get_dataset_info` calls it for a
    name the registry lacks.
    """
    path = path or os.environ.get(EXTRA_DATASETS_ENV)
    if not path or not os.path.exists(path):
        return []
    try:
        import yaml
    except ImportError:
        raise ImportError(f"reading the dataset list {path} needs PyYAML (the 'yaml' package), "
                          f"which is not installed") from None

    names = []
    dtype_map = {"float64": np.float64, "float32": np.float32}
    with open(path) as f:
        entries = yaml.safe_load(f) or []
    for entry in entries:
        entry = dict(entry)
        if "cloud_dtype" in entry:
            dt = str(entry["cloud_dtype"])
            if dt not in dtype_map:
                # a typo must name the file and entry, not end the CLI
                # with a bare KeyError
                raise ValueError(
                    f"{path}: dataset {entry.get('name', '?')!r} has "
                    f"cloud_dtype={dt!r}; supported: {sorted(dtype_map)}"
                )
            entry["cloud_dtype"] = dtype_map[dt]
        if "global_offset" in entry:
            entry["global_offset"] = np.asarray(
                entry["global_offset"], np.float64
            ).reshape(1, -1)
        info = _register(DatasetInfo(**entry))
        names.append(info.name)
    return names




def get_dataset_info(name: str) -> DatasetInfo:
    """The registry's entry for ``name``, registering the datasets of
    ``PCR_EXTRA_DATASETS`` first when ``name`` is not yet known."""
    if name not in dataset_info_dict:
        load_extra_datasets()
    if name not in dataset_info_dict:
        raise KeyError(f"dataset {name!r} is not registered; known: {sorted(dataset_info_dict)} "
                       f"(more can be listed in a YAML file named by {EXTRA_DATASETS_ENV})")
    return dataset_info_dict[name]

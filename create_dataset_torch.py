#!/usr/bin/env python
"""Dataset creation CLI of the PyTorch/CUDA port (``patchaugnet_tpu_torch``).

The port's counterpart of ``create_dataset.py`` (the reference's
``datasets/place_recognition_dataset.py`` __main__,
create_pointnet_vlad_dataset, :150-173): walks trip dirs under
PCR_DATA_ROOT/<dataset>, builds positive/negative tuples by radius
search, and pickles everything for training/eval. It needs neither
pandas nor sklearn, so the card's machine can build its own datasets;
the pickles it writes hold no pandas object.

Usage:
  PCR_DATA_ROOT=/path/to/benchmark_datasets \
      python create_dataset_torch.py --datasets oxford university
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description="Create place-recognition datasets (PyTorch/CUDA port)")
    p.add_argument("--datasets", nargs="+", default=["oxford"],
                   help="registry names (see patchaugnet_tpu_torch.data.dataset_info)")
    p.add_argument("--splits", nargs="+", default=["train", "test"],
                   choices=["train", "test"])
    args = p.parse_args(argv)

    from patchaugnet_tpu_torch.data import SceneDataset

    for name in args.datasets:
        for split in args.splits:
            print(f"Create Place Recognition Dataset: {name} [{split}]")
            ds = SceneDataset(name, for_training=split == "train")
            ds.create()
            print(
                f"  trips: {ds.trip_names}, records: {len(ds.records)}, "
                f"pickles -> {ds.pickle_dir()}"
            )


if __name__ == "__main__":
    main()

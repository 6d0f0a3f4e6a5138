"""MinkLoc INI config parsing.

The port's copy of ``patchaugnet_tpu/models/minkloc_config.py`` (that
module imports no JAX, but the port imports nothing of the JAX package):
the reference's configparser-based ``TrainingParams`` / ``ModelParams``
(place_recognition/Minkloc3D_V2/misc/utils.py:12-80, 85-175). The same
INI schema (``[MODEL]`` model file + ``[DEFAULT]``/``[TRAIN]`` training
file) parses into plain dataclasses, so reference config files drive the
port unchanged.
"""
from __future__ import annotations

import configparser
import dataclasses
import os
from typing import List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass
class ModelParams:
    model: str = "MinkLoc"
    output_dim: int = 256
    coordinates: str = "polar"
    quantization_step: Union[float, Tuple[float, ...], None] = None
    normalize_embeddings: bool = False
    feature_size: int = 256
    planes: Tuple[int, ...] = (32, 64, 64)
    layers: Tuple[int, ...] = (1, 1, 1)
    num_top_down: int = 1
    conv0_kernel_size: int = 5
    block: str = "BasicBlock"
    pooling: str = "GeM"
    # sparse-backend static per-level table capacities (len layers+1);
    # None = full capacity (see minkloc_sparse.suggest_level_capacities)
    level_capacity: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_ini(cls, path: str) -> "ModelParams":
        config = configparser.ConfigParser()
        config.read(path)
        p = config["MODEL"]
        coordinates = p.get("coordinates", "polar")
        if "polar" in coordinates:
            qs: Union[float, Tuple[float, ...], None] = tuple(
                float(e) for e in p["quantization_step"].split(",")
            )
        else:
            qs = p.getfloat("quantization_step")
        return cls(
            model=p.get("model"),
            output_dim=p.getint("output_dim", 256),
            coordinates=coordinates,
            quantization_step=qs,
            normalize_embeddings=p.getboolean("normalize_embeddings", False),
            feature_size=p.getint("feature_size", 256),
            planes=tuple(int(e) for e in p.get("planes", "32,64,64").split(",")),
            layers=tuple(int(e) for e in p.get("layers", "1,1,1").split(",")),
            num_top_down=p.getint("num_top_down", 1),
            conv0_kernel_size=p.getint("conv0_kernel_size", 5),
            block=p.get("block", "BasicBlock"),
            pooling=p.get("pooling", "GeM"),
            level_capacity=(
                tuple(int(e) for e in p["level_capacity"].split(","))
                if "level_capacity" in p else None
            ),
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TrainingParams:
    params_path: str = ""
    model_params_path: str = ""
    dataset_folder: str = ""
    save_freq: int = 0
    num_workers: int = 0
    batch_size: int = 64
    batch_split_size: Optional[int] = None
    batch_expansion_th: Optional[float] = None
    batch_size_limit: int = 64
    batch_expansion_rate: Optional[float] = None
    val_batch_size: int = 64
    lr: float = 1e-3
    epochs: int = 20
    optimizer: str = "Adam"
    scheduler: Optional[str] = "MultiStepLR"
    scheduler_milestones: Sequence[int] = ()
    min_lr: Optional[float] = None
    weight_decay: Optional[float] = None
    loss: str = "truncatedsmoothap"
    pos_margin: Optional[float] = None
    neg_margin: Optional[float] = None
    margin: Optional[float] = None
    positives_per_query: int = 4
    tau1: float = 0.01
    similarity: str = "euclidean"
    aug_mode: int = 1
    set_aug_mode: int = 1
    train_file: Optional[str] = None
    val_file: Optional[str] = None
    test_file: Optional[str] = None
    model_params: Optional[ModelParams] = None

    @classmethod
    def from_ini(cls, params_path: str, model_params_path: str) -> "TrainingParams":
        assert os.path.exists(params_path), params_path
        assert os.path.exists(model_params_path), model_params_path
        config = configparser.ConfigParser()
        config.read(params_path)
        d = config["DEFAULT"]
        t = config["TRAIN"]
        out = cls(
            params_path=params_path,
            model_params_path=model_params_path,
            dataset_folder=d.get("dataset_folder", ""),
            save_freq=t.getint("save_freq", 0),
            num_workers=t.getint("num_workers", 0),
            batch_size=t.getint("batch_size", 64),
            batch_split_size=t.getint("batch_split_size", None),
            batch_expansion_th=t.getfloat("batch_expansion_th", None),
            val_batch_size=t.getint("val_batch_size", t.getint("batch_size", 64)),
            lr=t.getfloat("lr", 1e-3),
            epochs=t.getint("epochs", 20),
            optimizer=t.get("optimizer", "Adam"),
            scheduler=t.get("scheduler", "MultiStepLR"),
            weight_decay=t.getfloat("weight_decay", None),
            loss=t.get("loss", "truncatedsmoothap").lower(),
            similarity=t.get("similarity", "euclidean"),
            aug_mode=t.getint("aug_mode", 1),
            set_aug_mode=t.getint("set_aug_mode", 1),
            train_file=t.get("train_file", None),
            val_file=t.get("val_file", None),
            test_file=t.get("test_file", None),
        )
        if out.batch_expansion_th is not None:
            assert 0.0 < out.batch_expansion_th < 1.0
            out.batch_size_limit = t.getint("batch_size_limit", 256)
            out.batch_expansion_rate = t.getfloat("batch_expansion_rate", 1.5)
            assert out.batch_expansion_rate > 1.0
        else:
            out.batch_size_limit = out.batch_size
        if out.scheduler == "CosineAnnealingLR":
            out.min_lr = t.getfloat("min_lr")
        elif out.scheduler == "MultiStepLR":
            ms = t.get("scheduler_milestones", None)
            out.scheduler_milestones = (
                [int(e) for e in ms.split(",")] if ms else [out.epochs + 1]
            )
        if "contrastive" in out.loss:
            out.pos_margin = t.getfloat("pos_margin", 0.2)
            out.neg_margin = t.getfloat("neg_margin", 0.65)
        elif "triplet" in out.loss:
            out.margin = t.getfloat("margin", 0.4)
        elif out.loss == "truncatedsmoothap":
            out.positives_per_query = t.getint("positives_per_query", 4)
            out.tau1 = t.getfloat("tau1", 0.01)
            out.margin = t.getfloat("margin", None)
        assert out.similarity in ("cosine", "euclidean")
        out.model_params = ModelParams.from_ini(model_params_path)
        return out

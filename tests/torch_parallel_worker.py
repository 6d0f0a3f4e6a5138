"""Rank programs of ``tests/test_torch_parallel.py`` and of the card test
in ``tests/test_torch_cuda.py``.

Each function runs on every rank of a world that ``parallel.spawn``
starts, computes every case of its world and returns the results
(``torch.save`` carries them to the parent). They import torch and the
port only: the parent holds them against the JAX package.
"""
import copy

import torch

from patchaugnet_tpu_torch import models, nn as pnn, ops, parallel, train
from patchaugnet_tpu_torch.compat import load_jax_variables
from patchaugnet_tpu_torch.losses import PatchCorrespondences


def _state(cfg, variables):
    model = load_jax_variables(models.get_model(cfg["model_type"], cfg), variables)
    return train.create_train_state(model, cfg, steps_per_epoch=1, device="cpu")


def _step_result(state, metrics, mesh):
    """The metrics, whether every rank of ``mesh`` holds the same
    parameters, statistics and gradients, and rank 0's of them."""
    model = state.model
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    flat = torch.cat([t.detach().reshape(-1).double() for t in
                      [*model.state_dict().values(), *(p.grad for p in model.parameters())]])
    hi, lo = flat.clone(), flat.clone()
    torch.distributed.all_reduce(hi, torch.distributed.ReduceOp.MAX, group=mesh.group())
    torch.distributed.all_reduce(lo, torch.distributed.ReduceOp.MIN, group=mesh.group())
    out["ranks_agree"] = bool(torch.equal(hi, lo))
    if mesh.rank == 0:
        out["params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out["grads"] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    return out


def _shard(t, mesh, axis):
    """This rank's contiguous block of the point axis (axis 1)."""
    n = t.shape[1] // mesh.shape[axis]
    i = mesh.index(axis)
    return t[:, i * n:(i + 1) * n]


def world(inp):
    """Every case, on a gloo world of four ranks on the CPU: all four ranks
    take the set-abstraction level on four point shards and on the 2 x 2
    mesh, then the mesh of ranks 0 and 1 the two-rank cases."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    solos = [torch.distributed.new_group([r]) for r in range(torch.distributed.get_world_size())]
    pair = parallel.make_mesh(2)
    points = parallel.make_mesh(4, axis_name="points")
    grid = parallel.make_mesh(shape={"data": 2, "points": 2})
    out = {"rank": rank, "default_slice": parallel.host_batch_slice(12)}
    out.update(_sa_cases(inp["sa"], points, grid))
    if pair is not None:
        out.update(_pair_cases(inp, pair, solos[rank]))
    return out


def _sa_cases(inp, points, grid):
    sa = load_jax_variables(models.backbone.PointNet2SAModule(inp["npoint"], inp["nsample"], inp["c"],
                                                              inp["widths"]), inp["variables"]).eval()
    xyz, feats = torch.from_numpy(inp["xyz"]), torch.from_numpy(inp["feats"])
    out = {}
    with torch.inference_mode():
        out["sa_points4"] = parallel.sharded_sa_level(sa.mlp, _shard(xyz, points, "points"),
                                                      _shard(feats, points, "points"), npoint=inp["npoint"],
                                                      nsample=inp["nsample"], mesh=points)
        rows = parallel.batch_sharded(grid, xyz.shape[0], "data")
        out["sa_grid"] = parallel.sharded_sa_level(sa.mlp, _shard(xyz[rows], grid, "points"),
                                                   _shard(feats[rows], grid, "points"), npoint=inp["npoint"],
                                                   nsample=inp["nsample"], mesh=grid, axis_name="points")
    out["grid_rows"] = rows
    return out


def _pair_cases(inp, mesh, solo):
    out = {"host_slice": parallel.host_batch_slice(10, mesh.rank, mesh.size)}

    # BatchNorm with a group of one: today's statistics bit for bit
    x = torch.from_numpy(inp["bn_x"])
    bn = pnn.BatchNorm(x.shape[-1])
    twin = copy.deepcopy(bn)
    plain = bn(x)
    with pnn.core.batch_stats_group(solo, 1):
        grouped = twin(x)
    out["bn_bits_equal"] = (torch.equal(plain, grouped) and torch.equal(bn.running_mean, twin.running_mean)
                            and torch.equal(bn.running_var, twin.running_var))

    # the data-parallel step without the patch branch, and with it at
    # A2A_MAX_CLOUDS below B x (1 + P)
    corr = PatchCorrespondences(*(torch.from_numpy(a) for a in inp["tables"]), inp["cfg"]["A2B_MAX_PAIRS"])
    rows = parallel.host_batch_slice(inp["clouds"].shape[0], mesh.rank, mesh.size)
    for name, cfg, variables in (("step", inp["plain_cfg"], inp["variables_nodec"]),
                                 ("step_a2a", inp["cfg_a2a"], inp["variables"])):
        state = _state(cfg, variables)
        step = parallel.build_parallel_train_step(state.model, cfg, mesh)
        state, metrics = step(state, parallel.make_global_batch(mesh, inp["clouds"][rows]), corr, inp["mask"][rows])
        out[name] = _step_result(state, metrics, mesh)

    # sharded eval: the global and the local forward
    model = load_jax_variables(models.get_model("patch_aug_net", inp["cfg_a2a"]), inp["variables"])
    records = inp["records"]
    out["forward"] = parallel.build_parallel_forward(model, mesh)(parallel.shard_batch(mesh, records))
    out["local_forward"] = parallel.build_parallel_local_forward(model, mesh)(parallel.shard_batch(mesh, records))

    # point-axis sharded ops over the two ranks
    xyz, q = torch.from_numpy(inp["xyz"]), torch.from_numpy(inp["q"])
    out["knn"] = parallel.sharded_knn(_shard(xyz, mesh, "data"), q, 10, mesh)
    out["fps"] = parallel.sharded_fps(_shard(xyz, mesh, "data"), 64, mesh)
    f, gidx = torch.from_numpy(inp["f"]), torch.from_numpy(inp["gidx"])
    out["group"] = parallel.sharded_group(_shard(f, mesh, "data"), gidx, mesh)
    db = torch.from_numpy(inp["db"])
    out["retrieval"] = parallel.sharded_topk_neighbors(torch.from_numpy(inp["queries"]),
                                                       _shard(db[None], mesh, "data")[0], 7, mesh)

    # point-sharded descriptors
    clouds = torch.from_numpy(inp["records"][:2])
    out["pan_desc"] = parallel.sharded_patchaugnet_descriptor(model, _shard(clouds, mesh, "data"), mesh,
                                                              axis_name="data")
    ppt = load_jax_variables(models.get_model("pptnet_l2_norm", inp["ppt_cfg"]), inp["ppt_variables"])
    out["ppt_desc"] = parallel.sharded_pptnet_descriptor(ppt, _shard(torch.from_numpy(inp["ppt_clouds"]), mesh,
                                                                      "data"), mesh, axis_name="data")
    pnv = load_jax_variables(models.get_model("pointnet_vlad", inp["pnv_cfg"]), inp["pnv_variables"])
    out["pnv_desc"] = parallel.sharded_pointnetvlad_descriptor(
        pnv, _shard(torch.from_numpy(inp["pnv_clouds"]), mesh, "data"), mesh, axis_name="data")

    # the point-sharded train step, its refusals and its gate
    cfg = inp["sharded_cfg"]
    state = _state(cfg, inp["variables_nodec"])
    step = parallel.build_sharded_train_step(cfg, mesh, axis_name="data")
    state, metrics = step(state, _shard(torch.from_numpy(inp["clouds"]), mesh, "data"))
    out["sharded_step"] = _step_result(state, metrics, mesh)
    ppt_cfg = inp["ppt_step_cfg"]
    state = _state(ppt_cfg, inp["ppt_variables"])
    state, metrics = parallel.build_sharded_train_step(ppt_cfg, mesh, axis_name="data")(
        state, _shard(torch.from_numpy(inp["clouds"]), mesh, "data"))
    out["ppt_sharded_step"] = _step_result(state, metrics, mesh)
    refusals = []
    for bad in (dict(cfg, use_patch_recon=True), dict(cfg, weight_place_recognition=0.5)):
        try:
            parallel.build_sharded_train_step(bad, mesh, axis_name="data")
        except ValueError as e:
            refusals.append(str(e))
    out["refusals"] = refusals
    gated = dict(cfg, MARGIN_1=-10.0, MARGIN_2=-10.0)
    state = _state(gated, inp["variables_nodec"])
    before = copy.deepcopy(state.model.state_dict())
    state, metrics = parallel.build_sharded_train_step(gated, mesh, axis_name="data")(
        state, _shard(torch.from_numpy(inp["clouds"]), mesh, "data"))
    out["gated"] = dict(_step_result(state, metrics, mesh), before=before)
    return out


def knn_on_one_card(xyz, q, k):
    """sharded_knn over the ranks sharing one card, and K2 on the whole
    cloud on the same card (``tests/test_torch_cuda.py``)."""
    mesh = parallel.make_mesh()
    xyz, q = torch.from_numpy(xyz).to(mesh.device), torch.from_numpy(q).to(mesh.device)
    idx, d2 = parallel.sharded_knn(_shard(xyz, mesh, "data"), q, k, mesh)
    ref_idx, ref_d2 = ops.knn(xyz, q, k)
    return idx, d2, ref_idx, ref_d2

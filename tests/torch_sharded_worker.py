"""Child-process bodies for the port's sharded CPU tests.

`run(fn, out_dir, world, **inputs)` saves the inputs to
`out_dir/inputs.pt` and has `torch.multiprocessing.spawn` run `fn` in
fresh processes, one per rank of a gloo group. The children import only
torch, numpy and the port (never JAX); each loads the inputs, computes,
and saves its result to `out_dir/rank<r>.pt`, and `run` returns the
ranks' results. The inputs go through a file, not spawn's arguments, so
that the children start at once (spawn writes each child's arguments to
it in turn). Rendezvous is through a file in out_dir, so parallel test
workers never share a port.
"""

from __future__ import annotations

import os

import torch


def run(fn, out_dir, world: int, **inputs):
    """fn(rank, world, out_dir, **inputs) on world gloo ranks; their results."""
    torch.save(inputs, os.path.join(out_dir, "inputs.pt"))
    torch.multiprocessing.spawn(_main, args=(fn, world, str(out_dir)), nprocs=world)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _main(rank: int, fn, world: int, out_dir: str):
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    fn(rank, world, out_dir, **inputs)


def _mesh(rank: int, world: int, out_dir: str):
    from cffm_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    return make_mesh(init_method=f"file://{os.path.join(out_dir, 'rdzv')}", rank=rank,
                     world_size=world, backend="gloo", device="cpu")


def _save(out_dir: str, rank: int, result: dict):
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def routing(rank: int, world: int, out_dir: str, ids, table_storage, drows, capacity: int,
            rows_per_shard: int, max_unique: int):
    """build_routing, routed_lookup and grad_return on this rank's block
    of ids (the global flat ids split evenly), its rows of the storage and
    its block of the row grads."""
    from cffm_tpu_torch.parallel import sharded_embedding as se
    from cffm_tpu_torch.parallel.mesh import close_mesh

    mesh = _mesh(rank, world, out_dir)
    try:
        n = len(ids) // world
        vs = rows_per_shard
        mine = torch.from_numpy(ids[rank * n:(rank + 1) * n])
        table = torch.from_numpy(table_storage[rank * vs:(rank + 1) * vs])
        r = se.build_routing(mine, capacity, mesh, rows_per_shard=vs)
        rows = se.routed_lookup(table, r, mesh)
        g = torch.from_numpy(drows[rank * n:(rank + 1) * n])
        if g.dtype == torch.int16:  # bf16 carried as its bits
            g = g.view(torch.bfloat16)
        row_ids, grads = se.grad_return(g, r, mesh, max_unique=max_unique)
        _save(out_dir, rank, {"recv_ids": r.recv_ids, "start": r.start,
                              "idx_of_pos": r.idx_of_pos, "overflow": r.overflow,
                              "rows": rows, "row_ids": row_ids, "grads": grads.float()})
    finally:
        close_mesh(mesh)


def train(rank: int, world: int, out_dir: str, cfg, np_state, batches, use_kernel: bool,
          eval_batches=()):
    """Steps of the sharded train step from rank's share of np_state (a
    JAX sharded state as numpy), one per (ids, labels) global batch, then
    sharded eval steps on eval_batches. Saves the losses, overflows, the
    state's shards and the eval results."""
    from cffm_tpu_torch.convert import sharded_state_from_jax
    from cffm_tpu_torch.metrics import auc_state_init
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.ops.interaction_conv import make_interaction_fn
    from cffm_tpu_torch.parallel.mesh import close_mesh
    from cffm_tpu_torch.parallel.sharded_train import (make_sharded_eval_step,
                                                       make_sharded_train_step)

    mesh = _mesh(rank, world, out_dir)
    try:
        fn = make_interaction_fn() if use_kernel else None
        state = sharded_state_from_jax(np_state, rank, world)
        step = make_sharded_train_step(cfg, mesh, fn)
        b = cfg.data.batch_size // world
        calls = {}

        def count(name, fun):
            def wrapped(*args, **kwargs):
                calls[name] = calls.get(name, 0) + 1
                return fun(*args, **kwargs)
            return wrapped

        # which plain versions the step reached (the CPU takes no kernel)
        ss.sorted_segment_by_seg_reference = count("by_seg", ss.sorted_segment_by_seg_reference)
        su.bucketed_apply_reference = count("bucketed", su.bucketed_apply_reference)
        su.streamed_apply_reference = count("streamed", su.streamed_apply_reference)
        losses, overflows = [], []
        for ids, labels in batches:
            state, m = step(state, torch.from_numpy(ids[rank * b:(rank + 1) * b]), None,
                            torch.from_numpy(labels[rank * b:(rank + 1) * b]))
            losses.append(float(m["loss"]))
            overflows.append(int(m["overflow"]))
        evals = []
        if eval_batches:
            ev = make_sharded_eval_step(cfg, mesh, fn)
            for ids, labels in eval_batches:
                auc, ovf = ev(state, auc_state_init(), torch.from_numpy(ids[rank * b:(rank + 1) * b]),
                              None, torch.from_numpy(labels[rank * b:(rank + 1) * b]))
                evals.append(({k: v.numpy() for k, v in auc.items()}, int(ovf)))
        _save(out_dir, rank, {"losses": losses, "overflows": overflows, "state": state,
                              "evals": evals, "calls": calls})
    finally:
        close_mesh(mesh)


def run_train(rank: int, world: int, out_dir: str, cfg):
    """train.run on this rank inside an already-initialised gloo group."""
    from cffm_tpu_torch import train
    from cffm_tpu_torch.parallel.mesh import close_mesh

    mesh = _mesh(rank, world, out_dir)
    try:
        logs = []
        result = train.run(cfg, device="cpu", log_fn=logs.append)
        _save(out_dir, rank, {"result": result, "logs": logs})
    finally:
        close_mesh(mesh)


def ckpt_cycle(rank: int, world: int, out_dir: str, cfg, ckpt_dir: str, np_state=None,
               save_batches=(), restore_batches=()):
    """With np_state (a JAX sharded state as numpy): rank's share of it,
    steps on save_batches, a save under world shards. Then restore_auto of
    the latest checkpoint onto world shards, into a state drawn from
    another seed, and steps on restore_batches. Saves the restored shards,
    the meta, the losses and the final state."""
    from cffm_tpu_torch.checkpoint import CheckpointManager
    from cffm_tpu_torch.convert import sharded_state_from_jax
    from cffm_tpu_torch.parallel.mesh import close_mesh
    from cffm_tpu_torch.parallel.sharded_train import (create_sharded_state,
                                                       make_sharded_train_step)

    mesh = _mesh(rank, world, out_dir)
    try:
        step = make_sharded_train_step(cfg, mesh)
        b = cfg.data.batch_size // world

        def steps(state, batches):
            losses = []
            for ids, labels in batches:
                state, m = step(state, torch.from_numpy(ids[rank * b:(rank + 1) * b]), None,
                                torch.from_numpy(labels[rank * b:(rank + 1) * b]))
                losses.append(float(m["loss"]))
            return state, losses

        mgr = CheckpointManager(ckpt_dir)
        saved = None
        if np_state is not None:
            state, _ = steps(sharded_state_from_jax(np_state, rank, world), save_batches)
            mgr.save(state.step, state, cfg, num_shards=world, wait=True)
            saved = state
        template = create_sharded_state(cfg, torch.Generator().manual_seed(99), mesh)
        state, meta = mgr.restore_auto(template, cfg, world)
        mgr.close()
        restored = {"table": state.params["embed"]["table"].clone(),
                    "sparse": {k: v.clone() for k, v in state.sparse_opt_state["embed"].items()},
                    "step": state.step}
        state, losses = steps(state, restore_batches)
        _save(out_dir, rank, {"saved": saved, "restored": restored, "meta": meta,
                              "losses": losses, "state": state})
    finally:
        close_mesh(mesh)


def run_preempted(rank: int, world: int, out_dir: str, cfg, request_rank: int, at_sync: int):
    """train.run on this rank with a guard that request_rank trips at its
    at_sync-th check; the other ranks never request a stop."""
    from cffm_tpu_torch import train
    from cffm_tpu_torch.parallel.mesh import close_mesh
    from cffm_tpu_torch.utils.preemption import PreemptionGuard

    class Guard(PreemptionGuard):
        checks = 0

        def sync(self):
            self.checks += 1
            if rank == request_rank and self.checks == at_sync:
                self.request()
            return super().sync()

    mesh = _mesh(rank, world, out_dir)
    try:
        result = train.run(cfg, device="cpu", log_fn=lambda s: None,
                           preemption_guard=Guard(install=False))
        _save(out_dir, rank, {"result": result})
    finally:
        close_mesh(mesh)


def probed_step(rank: int, world: int, out_dir: str, cfg, np_state, ids, labels):
    """One sharded step from rank's share of np_state with
    cfg.debug_barriers off and one with it on, stdout captured."""
    import contextlib
    import dataclasses
    import io

    from cffm_tpu_torch.convert import sharded_state_from_jax
    from cffm_tpu_torch.parallel.mesh import close_mesh
    from cffm_tpu_torch.parallel.sharded_train import make_sharded_train_step

    mesh = _mesh(rank, world, out_dir)
    try:
        b = cfg.data.batch_size // world
        mine = (torch.from_numpy(ids[rank * b:(rank + 1) * b]), None,
                torch.from_numpy(labels[rank * b:(rank + 1) * b]))
        out = {}
        for on in (False, True):
            c = dataclasses.replace(cfg, debug_barriers=on)
            state = sharded_state_from_jax(np_state, rank, world)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                state, m = make_sharded_train_step(c, mesh)(state, *mine)
            out[on] = {"loss": float(m["loss"]), "table": state.params["embed"]["table"],
                       "printed": buf.getvalue()}
        _save(out_dir, rank, out)
    finally:
        close_mesh(mesh)


def full_pass(rank: int, world: int, out_dir: str, cfg, params, run_cfg):
    """A full-pass eval of this rank's held-out split with the sharded eval
    step, from rank's mod-shard of the natural-order params (local row l is
    global row l * world + rank); then train.run(run_cfg) in the same group
    (its own sharded state). Saves the AUC state and run's result."""
    from cffm_tpu_torch import train
    from cffm_tpu_torch.metrics import auc_state_init
    from cffm_tpu_torch.parallel.mesh import close_mesh
    from cffm_tpu_torch.parallel.sharded_train import make_sharded_eval_step

    mesh = _mesh(rank, world, out_dir)
    try:
        def shard(table):
            pad = -len(table) % world
            return torch.cat([table, table.new_zeros((pad, table.shape[1]))])[rank::world]

        params = dict(params, embed={"table": shard(params["embed"]["table"])})
        if "table" in params.get("linear", {}):
            params["linear"] = dict(params["linear"], table=shard(params["linear"]["table"]))
        state = train.TrainState(0, params, {}, {})
        step = make_sharded_eval_step(cfg, mesh, train.default_interaction_fn(cfg))
        batches = []

        def eval_fn(auc_state, ids, dense, labels, mask=None):
            batches.append(int(mask.sum()))
            return step(state, auc_state, ids, dense, labels, mask)[0]

        auc = train._full_pass_eval(cfg, eval_fn, auc_state_init(), rank, world,
                                    torch.device("cpu"), mesh.group)
        result = train.run(run_cfg, device="cpu", log_fn=lambda *_: None)
        _save(out_dir, rank, {"auc": auc, "rows": batches, "result": result})
    finally:
        close_mesh(mesh)


def _mesh2d(rank: int, world: int, out_dir: str, num_hosts: int):
    """The (host, chip) grid of a gloo group of world ranks, num_hosts hosts."""
    from cffm_tpu_torch.parallel.mesh import make_mesh_2d

    torch.set_num_threads(1)
    return make_mesh_2d(num_hosts, world // num_hosts,
                        init_method=f"file://{os.path.join(out_dir, 'rdzv')}", rank=rank,
                        world_size=world, backend="gloo", device="cpu")


def _bf16(a):
    """A numpy array (bf16 carried as int16 bits) as a tensor."""
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if t.dtype == torch.int16 else t


def hier_engine(rank: int, world: int, out_dir: str, num_hosts: int, keyed, hier):
    """keyed: build_routing(keys=) on the flat group, on this rank's block
    of keyed["keys"]. hier: for each case, build_routing_hier,
    hier_routed_lookup and hier_grad_return on this rank's block of ids,
    its rows of the storage and its block of the row grads."""
    from cffm_tpu_torch.parallel import hier_embedding as he
    from cffm_tpu_torch.parallel import sharded_embedding as se
    from cffm_tpu_torch.parallel.mesh import close_mesh

    mesh2d = _mesh2d(rank, world, out_dir, num_hosts)
    try:
        n = len(keyed["keys"]) // world
        k = torch.from_numpy(keyed["keys"][rank * n:(rank + 1) * n])
        r = se.build_routing(k.int(), keyed["capacity"], mesh2d.flat,
                             rows_per_shard=keyed["stride"], keys=k)
        out = {"keyed": {name: getattr(r, name) for name in
                         ("order", "seg", "idx_of_pos", "start", "recv_ids", "overflow")}}
        for name, case in hier.items():
            n = len(case["ids"]) // world
            vs = case["rows_per_shard"]
            ids = torch.from_numpy(case["ids"][rank * n:(rank + 1) * n])
            table = torch.from_numpy(case["storage"][rank * vs:(rank + 1) * vs])
            hr = he.build_routing_hier(ids, case["cap1"], case["cap2"], mesh2d, vs)
            rows = he.hier_routed_lookup(table, hr, mesh2d)
            g = _bf16(case["drows"][rank * n:(rank + 1) * n])
            row_ids, grads = he.hier_grad_return(g, hr, mesh2d, *case["max_unique"])
            out[name] = {"r1_recv_ids": hr.r1.recv_ids, "r2_recv_ids": hr.r2.recv_ids,
                         "r1_idx_of_pos": hr.r1.idx_of_pos, "r2_idx_of_pos": hr.r2.idx_of_pos,
                         "overflow": he.hier_overflow(hr), "rows": rows,
                         "row_ids": row_ids, "grads": grads.float()}
        _save(out_dir, rank, out)
    finally:
        close_mesh(mesh2d.flat)


def grid_train(rank: int, world: int, out_dir: str, num_hosts: int, jobs):
    """Each job {"engine": "flat" | "hier" | "2d", "cfg", "np_state" (a JAX
    sharded state as numpy: the flat layout over world for flat and hier,
    the intra-host layout for 2d; None for 2d: create_sharded_state_2d
    from seed 0), "batches" [(ids, dense | None, labels)]
    global, "use_kernel", "eval_batches"} on the (host, chip) grid:
    rank's share of the state, the engine's steps, then its eval steps.
    Saves per job the losses, overflows (and for hier the router's
    per-stage report of each step), state and evals."""
    from cffm_tpu_torch.convert import sharded_state_2d_from_jax, sharded_state_from_jax
    from cffm_tpu_torch.metrics import auc_state_init
    from cffm_tpu_torch.ops.interaction_conv import make_interaction_fn
    from cffm_tpu_torch.parallel import dcn_mesh
    from cffm_tpu_torch.parallel import sharded_train as st
    from cffm_tpu_torch.parallel.mesh import close_mesh

    mesh2d = _mesh2d(rank, world, out_dir, num_hosts)
    try:
        out = {}
        for name, job in jobs.items():
            cfg, engine = job["cfg"], job["engine"]
            fn = make_interaction_fn() if job["use_kernel"] else None
            if engine == "2d":
                state = (dcn_mesh.create_sharded_state_2d(
                    cfg, torch.Generator().manual_seed(0), mesh2d) if job["np_state"] is None
                    else sharded_state_2d_from_jax(job["np_state"], rank, mesh2d.chips_per_host))
                step = dcn_mesh.make_sharded_train_step_2d(cfg, mesh2d, fn)
                ev = dcn_mesh.make_sharded_eval_step_2d(cfg, mesh2d, fn)
            elif engine == "hier":
                state = sharded_state_from_jax(job["np_state"], rank, world)
                step = st.make_sharded_train_step_hier(cfg, mesh2d, fn)
                ev = st.make_sharded_eval_step_hier(cfg, mesh2d, fn)
            else:
                state = sharded_state_from_jax(job["np_state"], rank, world)
                step = st.make_sharded_train_step(cfg, mesh2d.flat, fn)
                ev = st.make_sharded_eval_step(cfg, mesh2d.flat, fn)
            b = cfg.data.batch_size // world

            def mine(a):
                return None if a is None else torch.from_numpy(a[rank * b:(rank + 1) * b])

            initial = state.params["embed"]["table"].clone()
            losses, overflows, stages = [], [], []
            for ids, dense, labels in job["batches"]:
                state, m = step(state, mine(ids), mine(dense), mine(labels))
                losses.append(float(m["loss"]))
                overflows.append(int(m["overflow"]))
                if engine == "hier":  # the router's report of this rank's two stages
                    stages.append(step.router.stage_overflow.tolist())
            evals = []
            for ids, dense, labels in job.get("eval_batches", ()):
                auc, ovf = ev(state, auc_state_init(), mine(ids), mine(dense), mine(labels))
                evals.append(({k: v.numpy() for k, v in auc.items()}, int(ovf)))
            out[name] = {"losses": losses, "overflows": overflows, "stages": stages,
                         "state": state, "evals": evals, "initial_table": initial}
        _save(out_dir, rank, out)
    finally:
        close_mesh(mesh2d.flat)


def grid_ckpt(rank: int, world: int, out_dir: str, num_hosts: int, cfg, cfg_2d, ckpt_dir: str,
              batches):
    """Checkpoints across the engines on the (host, chip) grid. Hier: two
    steps, a save under world shards, restore_auto into a flat state drawn
    from another seed, one flat step and a save; restore_auto of that into
    a hier state, and one hier step from the saved hier state beside it.
    2d (cfg_2d): two steps, a save under C shards (host 0's ranks write),
    restore_auto into a 2d state and into a flat state over world shards.
    Saves the states along the way."""
    from cffm_tpu_torch.checkpoint import CheckpointManager
    from cffm_tpu_torch.parallel import dcn_mesh
    from cffm_tpu_torch.parallel import sharded_train as st
    from cffm_tpu_torch.parallel.mesh import close_mesh

    mesh2d = _mesh2d(rank, world, out_dir, num_hosts)
    flat, c = mesh2d.flat, mesh2d.chips_per_host
    b = cfg.data.batch_size // world

    def run(step, state, batch):
        ids, labels = batch
        return step(state, torch.from_numpy(ids[rank * b:(rank + 1) * b]), None,
                    torch.from_numpy(labels[rank * b:(rank + 1) * b]))

    def snap(state):
        return {"table": state.params["embed"]["table"].clone(),
                "accum": state.sparse_opt_state["embed"]["accum"].clone(), "step": state.step}

    def fresh_flat(c_, seed):
        return st.create_sharded_state(c_, torch.Generator().manual_seed(seed), flat)

    def fresh_2d(seed):
        return dcn_mesh.create_sharded_state_2d(cfg_2d, torch.Generator().manual_seed(seed),
                                                mesh2d)

    try:
        out = {}
        hstep = st.make_sharded_train_step_hier(cfg, mesh2d)
        fstep = st.make_sharded_train_step(cfg, flat)
        mgr = CheckpointManager(os.path.join(ckpt_dir, "hier"))
        state = fresh_flat(cfg, 9)
        for batch in batches[:2]:
            state, _ = run(hstep, state, batch)
        mgr.save(2, state, cfg, num_shards=world, wait=True)
        out["hier_saved"] = snap(state)
        restored, meta = mgr.restore_auto(fresh_flat(cfg, 0), cfg, world)
        out["flat_restored"], out["hier_meta"] = snap(restored), meta
        cont_f, mf = run(fstep, restored, batches[2])
        cont_h, mh = run(hstep, state, batches[2])
        out["flat_next"], out["hier_next"] = snap(cont_f), snap(cont_h)
        out["losses_next"] = (float(mf["loss"]), float(mh["loss"]))
        mgr.save(3, cont_f, cfg, num_shards=world, wait=True)
        back, _ = mgr.restore_auto(fresh_flat(cfg, 1), cfg, world)
        out["hier_restored"] = snap(back)
        mgr.close()

        step2 = dcn_mesh.make_sharded_train_step_2d(cfg_2d, mesh2d)
        mgr = CheckpointManager(os.path.join(ckpt_dir, "2d"))
        state = fresh_2d(4)
        for batch in batches[:2]:
            state, _ = run(step2, state, batch)
        mgr.save(2, state, cfg_2d, num_shards=c, wait=True)
        out["2d_saved"] = snap(state)
        out["2d_files"] = sorted(os.listdir(os.path.join(ckpt_dir, "2d", "2")))
        restored, meta = mgr.restore_auto(fresh_2d(5), cfg_2d, c)
        out["2d_restored"], out["2d_meta"] = snap(restored), meta
        restored, _ = mgr.restore_auto(fresh_flat(cfg_2d, 6), cfg_2d, world)
        out["2d_as_flat"] = snap(restored)
        mgr.close()
        _save(out_dir, rank, out)
    finally:
        close_mesh(flat)


def run_train_grid(rank: int, world: int, out_dir: str, cfgs, chips_per_host: int):
    """train.run of each config in turn inside one gloo group, with
    torchrun's LOCAL_WORLD_SIZE set to chips_per_host."""
    from cffm_tpu_torch import train
    from cffm_tpu_torch.parallel.mesh import close_mesh

    os.environ["LOCAL_WORLD_SIZE"] = str(chips_per_host)
    mesh = _mesh(rank, world, out_dir)
    try:
        out = []
        for cfg in cfgs:
            logs = []
            out.append({"result": train.run(cfg, device="cpu", log_fn=logs.append),
                        "logs": logs})
        _save(out_dir, rank, out)
    finally:
        close_mesh(mesh)


def bench_scaling(rank: int, world: int, out_dir: str, cfg, batch: int, hier, np_state):
    """scripts.bench_scaling.run on the group from the natural-order state
    np_state (a JAX state as numpy), one timed step each."""
    from cffm_tpu_torch.convert import state_from_jax
    from cffm_tpu_torch.parallel.mesh import close_mesh
    from cffm_tpu_torch.scripts import bench_scaling as bs

    mesh = _mesh(rank, world, out_dir)
    try:
        _save(out_dir, rank, bs.run(cfg, batch, mesh, hier, n=1, state=state_from_jax(np_state)))
    finally:
        close_mesh(mesh)

"""The port's packed wire format: the JAX package's layout and bytes,
`unpack` equal to JAX's on ids that use every bit of each field's width
(bit 15 of the uint16 columns, bit 31 of the hi words), `train_step_wire`
equal to `train_step` on the unpacked batch, the packed stream of
`make_dataset` equal to JAX's, and the flat sharded engine's
`wrap_wire_step` equal to its raw step."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cffm_tpu.data import wire as jax_wire
from cffm_tpu.data.loader import make_dataset as jax_make_dataset
from cffm_tpu_torch import config, train
from cffm_tpu_torch.data import wire
from cffm_tpu_torch.data.loader import make_dataset
from cffm_tpu_torch.models.cffm import field_offsets
from cffm_tpu_torch.optim.rowwise import tree_leaves

import torch_data_files as files

VOCABS = {
    "criteo_kaggle": config.get_config("criteo_kaggle").model.vocab_sizes,
    "avazu": config.get_config("avazu").model.vocab_sizes,
    "every_class": (2, 256, 257, 40_000, 65536, 65537, 1_000_000, 16_000_000),
    # hi bits at offsets 0, 15 and 30: the third field's reach bit 31
    "hi_bit_31": (2**31, 2**31, 2**18, 300),
}


def _edge_ids(vocabs, b=257, seed=0):
    """Random ids per field, plus rows of 0, of vocab - 1 (every bit of the
    field's width), and of the largest id with bit 15 of its low half set."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, size=b) for v in vocabs], axis=1).astype(np.int64)
    ids[0] = 0
    ids[1] = np.asarray(vocabs) - 1
    top = np.asarray(vocabs, np.int64) - 1
    lo15 = (top & ~np.int64(0xFFFF)) | 0x8000
    lo15 = np.where(lo15 > top, lo15 - 0x10000, lo15)
    ids[2] = np.where(lo15 >= 0, lo15, top)
    return ids


@pytest.mark.parametrize("name", sorted(VOCABS))
def test_spec_and_pack_equal_jax(name):
    vocabs = VOCABS[name]
    spec, jspec = wire.from_vocabs(vocabs, 3), jax_wire.from_vocabs(vocabs, 3)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert spec.bytes_per_row() == jspec.bytes_per_row()
    ids = _edge_ids(vocabs)
    dense = np.random.default_rng(1).normal(size=(len(ids), 3)).astype(np.float32)
    labels = (np.arange(len(ids)) % 3 == 0).astype(np.float32)
    got, want = wire.pack(ids, dense, labels, spec), jax_wire.pack(ids, dense, labels, jspec)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_criteo_layout():
    spec = wire.spec_for_model(config.get_config("criteo_kaggle").model)
    assert len(spec.u8_fields) == 13 and len(spec.big_fields) == 26
    assert spec.big_hi_bits == (1,) * 26 and spec.hi_words == 1
    assert spec.bytes_per_row() == 96


@pytest.mark.parametrize("carry", ["signed_views", "unsigned_tensors", "numpy"])
@pytest.mark.parametrize("name", sorted(VOCABS))
def test_unpack_equals_jax_on_every_bit(name, carry):
    vocabs = VOCABS[name]
    spec = wire.from_vocabs(vocabs, 2)
    ids = _edge_ids(vocabs, seed=3)
    dense = np.random.default_rng(4).normal(size=(len(ids), 2)).astype(np.float32)
    labels = (np.arange(len(ids)) % 2).astype(np.float32)
    packed = wire.pack(ids, dense, labels, spec)
    if "hi" in packed and name == "hi_bit_31":
        assert (packed["hi"][1, 0] >> 31) == 1
    for key, fields in (("u16", spec.u16_fields), ("big_lo", spec.big_fields)):
        for j, f in enumerate(fields):
            if vocabs[f] > 1 << 15:
                assert packed[key][2, j] >= 1 << 15, (key, f)
    if carry == "signed_views":
        feed = {k: wire.host_tensor(v) for k, v in packed.items()}
        assert all(t.dtype in (torch.uint8, torch.int16, torch.int32, torch.float16)
                   for t in feed.values())
    elif carry == "unsigned_tensors":
        feed = {k: torch.from_numpy(v) for k, v in packed.items()}
    else:
        feed = packed
    got_ids, got_dense, got_labels = wire.unpack(feed, spec)
    want_ids, want_dense, want_labels = jax.tree.map(
        np.asarray, jax_wire.unpack(jax_wire.pack(ids, dense, labels, spec), spec))
    assert got_ids.dtype == torch.int32 and got_labels.dtype == torch.float32
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    np.testing.assert_array_equal(got_dense.numpy(), want_dense)
    np.testing.assert_array_equal(got_labels.numpy(), want_labels)


def test_wire_refuses_what_it_cannot_carry():
    with pytest.raises(ValueError, match="too large"):
        wire.from_vocabs((2**32,))
    spec = wire.from_vocabs((10,))
    with pytest.raises(ValueError, match="binary labels"):
        wire.pack(np.zeros((2, 1), np.int32), None, np.array([0.5, 1.0]), spec)


def _wire_cfg(**data):
    return config.TrainConfig(
        name="wire", model=config.ModelConfig(
            num_fields=6, vocab_sizes=(40, 200, 300, 70000, 100000, 64), embed_dim=8,
            conv_channels=(16,), tower_hidden=(32,), num_dense=3, compute_dtype="float32"),
        data=config.DataConfig(**{"batch_size": 64, "num_train_steps": 4, "eval_batches": 2,
                                  "seed": 7, **data}),
        log_every=1)


def _f16_exact_batch(cfg, seed):
    mcfg = cfg.model
    ids = _edge_ids(mcfg.vocab_sizes, b=cfg.data.batch_size, seed=seed).astype(np.int32)
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(len(ids), mcfg.num_dense)).astype(np.float16).astype(np.float32)
    labels = (rng.random(len(ids)) < 0.3).astype(np.float32)
    return ids, dense, labels


def _assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params), strict=True):
        assert torch.equal(x, y)


def test_train_step_wire_matches_train_step():
    cfg = _wire_cfg()
    spec = wire.spec_for_model(cfg.model)
    fn = train.default_interaction_fn(cfg)
    s_raw = train.create_state(cfg, torch.Generator().manual_seed(0))
    s_wire = train.create_state(cfg, torch.Generator().manual_seed(0))
    offs = field_offsets(cfg.model)[None, :].astype(np.int32)
    for seed in range(2):
        ids, dense, labels = _f16_exact_batch(cfg, seed)
        s_raw, m_raw = train.train_step(s_raw, torch.from_numpy(ids + offs),
                                        torch.from_numpy(dense), torch.from_numpy(labels),
                                        cfg, fn)
        packed = {k: wire.host_tensor(v) for k, v in wire.pack(ids, dense, labels, spec).items()}
        s_wire, m_wire = train.train_step_wire(s_wire, packed, spec, cfg, fn)
        assert float(m_raw["loss"]) == float(m_wire["loss"])
    _assert_states_equal(s_raw, s_wire)


def test_sharded_wire_step_matches_raw(tmp_path):
    """wrap_wire_step on a gloo group of one: the packed batch drives the
    flat sharded step to the raw step's loss and tables bit for bit."""
    from cffm_tpu_torch.parallel.mesh import close_mesh, make_mesh
    from cffm_tpu_torch.parallel.sharded_train import (create_sharded_state,
                                                       make_sharded_train_step, wrap_wire_step)

    cfg = _wire_cfg()
    cfg = dataclasses.replace(cfg, sharding=config.ShardingConfig(table_sharded=True))
    spec = wire.spec_for_model(cfg.model)
    mesh = make_mesh(init_method=f"file://{tmp_path / 'rdzv'}", rank=0, world_size=1,
                     backend="gloo", device="cpu")
    try:
        fn = train.default_interaction_fn(cfg)
        s_raw = create_sharded_state(cfg, torch.Generator().manual_seed(0), mesh)
        s_wire = create_sharded_state(cfg, torch.Generator().manual_seed(0), mesh)
        step = make_sharded_train_step(cfg, mesh, fn)
        wire_step = wrap_wire_step(step, spec, cfg.model)
        offs = field_offsets(cfg.model)[None, :].astype(np.int32)
        for seed in range(2):
            ids, dense, labels = _f16_exact_batch(cfg, seed)
            s_raw, m_raw = step(s_raw, torch.from_numpy(ids + offs), torch.from_numpy(dense),
                                torch.from_numpy(labels))
            s_wire, m_wire = wire_step(s_wire, wire.pack(ids, dense, labels, spec))
            assert float(m_raw["loss"]) == float(m_wire["loss"])
        _assert_states_equal(s_raw, s_wire)
    finally:
        close_mesh(mesh)
    assert not dist.is_initialized()


@pytest.mark.parametrize("source", ["synthetic", "tsv"])
def test_make_dataset_packed_stream_bit_equal_jax(tmp_path, source):
    """wire_format="packed" packs the repeat-mode train stream only; its
    wire dicts equal JAX's and unpack to the raw stream's local ids."""
    data = dict(batch_size=128, wire_format="packed")
    if source == "tsv":
        from cffm_tpu_torch.scripts.bench_input import _write_criteo

        path = str(tmp_path / "c.tsv")
        _write_criteo(path, 2000)
        data.update(path=path, dataset="criteo", val_every=0)  # one chunk: no split
    jcfg, cfg = files.cfg_pair("criteo_kaggle", **data)
    files.assert_streams_equal(
        (b for b, _ in zip(jax_make_dataset(jcfg, prefetch=0), range(20))),
        (b for b, _ in zip(make_dataset(cfg, prefetch=2), range(20))), min_batches=20)
    raw_cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, wire_format="raw"))
    spec = wire.spec_for_model(cfg.model)
    offs = field_offsets(cfg.model)[None, :].astype(np.int32)
    for packed, raw, _ in zip(make_dataset(cfg, prefetch=0), make_dataset(raw_cfg, prefetch=0),
                              range(3)):
        ids, _, labels = wire.unpack(packed["wire"], spec)
        np.testing.assert_array_equal(ids.numpy() + offs, raw["ids"])
        np.testing.assert_array_equal(labels.numpy(), raw["labels"])
    val = next(make_dataset(cfg, prefetch=0, split="val"))
    assert "wire" not in val and val["ids"].dtype == np.int32


def test_run_packed_equals_run_raw_without_dense():
    """With no dense features the wire is exact, so a packed run equals a
    raw run: the same losses and eval."""
    results = {}
    for fmt in ("raw", "packed"):
        cfg = _wire_cfg(wire_format=fmt)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, num_dense=0))
        logs = []
        result = train.run(cfg, device="cpu", log_fn=logs.append)
        results[fmt] = (result, [json.loads(x)["loss"] for x in logs if '"loss"' in x])
    assert results["packed"] == results["raw"]
    assert np.isfinite(results["raw"][0]["final_train_loss"])


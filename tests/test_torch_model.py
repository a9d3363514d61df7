"""The port's forward (CPU) vs `cffm_tpu.models.cffm.forward`.

Identical params (JAX init, carried over by params_from_jax) and
identical batches. The JAX side runs the fused kernel in Pallas
interpret mode (bt=8). f32 compute: rtol 2e-4, atol 2e-5; bf16 compute:
atol 3e-2 on logits (bf16 rounds at other places in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.config import ModelConfig as JaxModelConfig
from cffm_tpu.models import cffm as jax_model
from cffm_tpu.ops.interaction_conv import make_interaction_fn as jax_make_fn
from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.convert import params_from_jax
from cffm_tpu_torch.models import cffm as model
from cffm_tpu_torch.ops import embed_lookup
from cffm_tpu_torch.ops import interaction_conv as ic

B = 16
# name -> (ModelConfig kwargs, the route forward must take)
CASES = {
    "hybrid_fm2": (dict(num_fields=15, vocab_sizes=(8,) * 4 + (600,) * 11), "fm2"),
    "all_small_fm": (dict(num_fields=15, vocab_sizes=(8,) * 15), "fm"),
    "full_rows": (dict(num_fields=15, vocab_sizes=(8,) * 4 + (600,) * 11,
                       small_field_threshold=0), "flat"),
    "no_fused_linear": (dict(num_fields=7, vocab_sizes=(61, 40, 2, 8, 22, 35, 19)),
                        "sliced"),
    "hadamard": (dict(num_fields=7, vocab_sizes=(61, 40, 2, 8, 22, 35, 19),
                      cross="hadamard"), "sliced"),
}

ROUTES = {"sliced": "cross_conv1", "flat": "cross_conv1_lin",
          "fm": "cross_conv1_lin_fm", "fm2": "cross_conv1_lin_fm2"}


def _cfgs(case, num_dense, compute_dtype="float32"):
    kw = dict(CASES[case][0], embed_dim=16, conv_channels=(8, 8),
              tower_hidden=(16,), num_dense=num_dense, compute_dtype=compute_dtype)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, size=B) for v in cfg.vocab_sizes], axis=1)
    ids = (ids + jax_model.field_offsets(cfg)[None, :]).astype(np.int32)
    dense = (rng.normal(size=(B, cfg.num_dense)).astype(np.float32)
             if cfg.num_dense else None)
    return ids, dense


def _both_logits(case, num_dense, compute_dtype="float32"):
    jcfg, cfg = _cfgs(case, num_dense, compute_dtype)
    params = jax_model.init_params(jax.random.key(5), jcfg)
    ids, dense = _batch(jcfg)
    want = jax_model.forward(
        params, jnp.asarray(ids), None if dense is None else jnp.asarray(dense),
        jcfg, interaction_fn=jax_make_fn(use_pallas=True, bt=8, interpret=True))
    ic.reset_launches()
    got = model.forward(
        params_from_jax(jax.tree.map(np.asarray, params)), torch.from_numpy(ids),
        None if dense is None else torch.from_numpy(dense), cfg,
        interaction_fn=ic.make_interaction_fn())
    return np.asarray(want, np.float32), got, cfg


@pytest.mark.parametrize("num_dense", [0, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case, num_dense, monkeypatch):
    calls = []
    for route, name in ROUTES.items():
        fn = getattr(ic, name)
        monkeypatch.setattr(ic, name, lambda *a, _fn=fn, _r=route: (
            calls.append(_r), _fn(*a))[1])
    want, got, cfg = _both_logits(case, num_dense)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    assert calls == [CASES[case][1]]


def test_forward_bf16_compute_matches_jax():
    want, got, _ = _both_logits("hybrid_fm2", 3, compute_dtype="bfloat16")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-2)


def test_forward_reference_route_matches_kernel_route():
    """interaction_fn=None (reference conv stack, batch-major gather)
    equals the fused hybrid route."""
    _, cfg = _cfgs("hybrid_fm2", 3)
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    ids, dense = _batch(cfg)
    ids, dense = torch.from_numpy(ids), torch.from_numpy(dense)
    ref = model.forward(params, ids, dense, cfg, interaction_fn=None)
    got = model.forward(params, ids, dense, cfg, interaction_fn=ic.make_interaction_fn())
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


def test_init_params_layouts_match_jax():
    jcfg, cfg = _cfgs("no_fused_linear", 3)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jax_model.init_params(jax.random.key(0), jcfg))
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                       params)
    assert got == want
    table = params["embed"]["table"]
    assert abs(table.std().item() - 0.01) < 1e-3


def test_lookups_clip_and_onehot_semantics():
    _, cfg = _cfgs("hybrid_fm2", 0)
    table = torch.arange(cfg.total_vocab * 2, dtype=torch.float32).reshape(-1, 2)
    ids = torch.tensor([[-5, 3], [cfg.total_vocab + 9, 0]], dtype=torch.int32)
    _, rows = embed_lookup.lookup_fm_reference(table, ids, (), table.dtype)
    np.testing.assert_array_equal(rows[:, :, 0].numpy(),
                                  [[0, 2 * (cfg.total_vocab - 1)], [6, 0]])
    # an id outside its field's block gives the one-hot product's zero row
    small = table[: cfg.small_rows]
    ids_fm = torch.tensor([[1, 9], [8, 3], [16, 16], [24, 31]], dtype=torch.int32)
    got = model.onehot_lookup_fm(small, ids_fm, cfg)
    want = small[ids_fm.long()]
    want[0, 1] = 0.0   # id 9 is not in field 0's block [0, 8)
    want[1, 1] = 0.0   # id 3 is not in field 1's block [8, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

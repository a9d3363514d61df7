"""On-card parity sweep of the kernels' numeric contracts.

    python -m cffm_tpu_torch.scripts.check_onchip_parity

The port's counterpart of `scripts/check_onchip_parity.py`, with its
cases, numpy references and tolerances. The CPU tests reach only the
plain versions, so a fault in a CUDA kernel's compiled code shows only
here (on the TPU a `<< 16` passed every interpret-mode test and then
corrupted ids >= 2^16 on the chip). Five checks:

  sorted_segment       kernel 3 at five (n, vmax) streams, W = 256: ids
                       >= 2^16 and >= 2^24, n not a multiple of the
                       kernel's chunk, a heavy-duplicate stream; uids and
                       count exact, gsum within 0.05 relative (bf16 grads).
                       The JAX kernel's `max_id` hint (its two rider paths)
                       has no counterpart: the CUDA kernel stores ids whole.
  streamed_apply       adagrad on a 140,000 x 256 f32 table, 4096 ids:
                       `optim.rowwise.rowwise_update` with streamed_update
                       "on" (kernels 3-4) against "off" (the scatter path):
                       table within 5e-3, accumulator within 5e-4.
  interaction_kernel   f = 15, d = 16, conv (16,), k = 3, B = 256, f32,
                       first-order column fused: kernel 1 on the
                       field-major and batch-major full-rows routes
                       (`models.cffm.forward_from_rows`) against the
                       reference conv (1e-3), and kernel 2 through autograd
                       on both routes against the reference's gradients
                       (2e-2 of the largest, rows and conv weight). TF32 is
                       off while it runs.
  embed_lookup         the field-major lookup (`ops.embed_lookup`, no JAX
                       counterpart) on a 140,000 x 256 table, B = 4096, 15
                       fields with a 5-field prefix of 64 ids each: f32 and
                       bf16 tables, int32, int64 and strided ids, bf16 and
                       f32 outputs, prefix ids outside their block and big
                       ids outside the table; bit-equal to the plain version.
  conv_tail_grad       a train step's forward and backward through the conv
                       tail's Function (its forward and backward kernels):
                       f = 15, d = 16, conv (64, 64), k = 3, pool 2, B = 300,
                       bf16, first-order column fused, on the field-major
                       full-rows route
                       (`models.cffm.forward_from_rows`); the logits and the
                       gradients to the rows and every conv leaf against the
                       same step on the CPU, whose tail is eager (2e-2 of the
                       largest, as the interaction check holds bf16).

On the card each check also requires its kernels' launch counts to rise:
a route that fell to a plain version fails. Prints `ONCHIP PARITY: OK` or
`FAIL` and exits 0 or 1; without a CUDA card it exits 2, refusing to pass
on the plain versions. The functions take `device` ("cpu" runs the plain
versions, as the tests do).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

import numpy as np
import torch

# (n, vmax) of the kernel-3 streams; W of their rows
SORTED_SEGMENT_CASES = ((8000, 26_000_000), (8192, 2_600_000), (12345, 70_000),
                        (8192, 3_000), (300, 17_000_000))
SEGMENT_W = 256


def _launched(fns, before, device: torch.device) -> bool:
    """On the card, every wrapper in fns launched since `before` (their
    counts then); on the CPU the plain versions ran and nothing is owed."""
    if device.type != "cuda":
        return True
    return all(fn.launches > n for fn, n in zip(fns, before))


def check_sorted_segment(device="cuda") -> bool:
    """uids, gsum and count of kernel 3 against a numpy reference."""
    from cffm_tpu_torch.ops.sorted_segment import sorted_segment_sum_compact

    device = torch.device(device)
    ok = True
    for trial, (n, vmax) in enumerate(SORTED_SEGMENT_CASES):
        rng = np.random.default_rng(trial)
        sid = np.sort(rng.integers(0, vmax, size=n)).astype(np.int32)
        grads = rng.normal(size=(n, SEGMENT_W)).astype(np.float32)
        uu, inv = np.unique(sid, return_inverse=True)
        m_pad = ((len(uu) + 255) // 128) * 128
        before = [sorted_segment_sum_compact.launches]
        uids, gsum, count = sorted_segment_sum_compact(
            torch.from_numpy(sid).to(device), torch.from_numpy(grads).to(device), m_pad)
        uids = uids.cpu().numpy()
        ref = np.zeros((len(uu), SEGMENT_W), np.float32)
        np.add.at(ref, inv, grads)
        got = gsum[: len(uu)].float().cpu().numpy()
        gerr = float(np.max(np.abs(got - ref) / (np.abs(ref) + 1)))
        good = (np.array_equal(uids[: len(uu)], uu)
                and int(count) == len(uu)
                and bool(np.all(uids[int(count):] == -1))
                and gerr < 0.05  # bf16 grad inputs
                and _launched([sorted_segment_sum_compact], before, device))
        print(f"sorted_segment[{trial}] n={n} vmax={vmax} uniq={len(uu)} gerr={gerr:.4f} "
              f"-> {'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


def check_streamed_apply(device="cuda") -> bool:
    """The streamed adagrad apply (kernels 3-4) against the scatter path
    on a table with ids past 2^16 rows."""
    from cffm_tpu_torch.config import OptimizerConfig
    from cffm_tpu_torch.ops.sorted_segment import sorted_segment_sum_compact
    from cffm_tpu_torch.ops.streamed_update import streamed_rowwise_apply
    from cffm_tpu_torch.optim.rowwise import rowwise_init, rowwise_update

    device = torch.device(device)
    rng = np.random.default_rng(7)
    v, w, n = 140_000, 256, 4096
    table = (0.01 * rng.normal(size=(v, w))).astype(np.float32)
    ids = rng.integers(0, v, size=n).astype(np.int32)
    grads = (0.01 * rng.normal(size=(n, w))).astype(np.float32)
    opt_s = OptimizerConfig(sparse_optimizer="adagrad", sparse_lr=0.05, streamed_update="on")
    opt_x = dataclasses.replace(opt_s, streamed_update="off")
    kernels = [sorted_segment_sum_compact, streamed_rowwise_apply]
    outs, launched = {}, True
    for name, opt in (("streamed", opt_s), ("scatter", opt_x)):
        t = torch.from_numpy(table).to(device)
        st = rowwise_init(t, opt)
        before = [fn.launches for fn in kernels]
        rowwise_update(t, st, torch.from_numpy(ids).to(device),
                       torch.from_numpy(grads).to(device), opt, max_unique=n + 1)
        if name == "streamed":
            launched = _launched(kernels, before, device)
        outs[name] = (t.cpu().numpy(), st["accum"].cpu().numpy())
    dt = float(np.max(np.abs(outs["streamed"][0] - outs["scatter"][0])))
    da = float(np.max(np.abs(outs["streamed"][1] - outs["scatter"][1])))
    # the streamed route sums bf16 grads; the scatter path sums f32
    good = dt < 5e-3 and da < 5e-4 and launched
    print(f"streamed_apply dtable={dt:.2e} daccum={da:.2e} -> {'ok' if good else 'FAIL'}",
          flush=True)
    return good


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _interaction_case(device: torch.device):
    from cffm_tpu_torch.config import ModelConfig
    from cffm_tpu_torch.models import cffm as model_lib

    f, d = 15, 16
    cfg = ModelConfig(num_fields=f, vocab_sizes=(32,) * f, embed_dim=d, cross="field_aware",
                      conv_channels=(16,), conv_kernel=3, compute_dtype="float32",
                      use_first_order=True)
    params = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(5)
    rows = torch.from_numpy((rng.normal(size=(256, f, cfg.table_width)) * 0.1)
                            .astype(np.float32)).to(device)
    return cfg, params, rows


def check_interaction_kernel(device="cuda") -> bool:
    """Kernel 1 (forward) and kernel 2 (backward through autograd) on the
    field-major and batch-major full-rows routes against the reference."""
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.ops import interaction_conv as ic

    device = torch.device(device)
    cfg, params, rows = _interaction_case(device)
    if not cfg.fused_linear:
        raise AssertionError("the case needs the fused first-order column")
    fn = ic.make_interaction_fn(use_kernel=True)

    fm = model_lib.Route(full_rows=True, field_major=True, prefix=0)
    routes = {"fm": fm, "bm": fm.batch_major(), "ref": model_lib.Route(False, False, 0)}

    def forward(route, p, r):
        rows = [r.transpose(0, 1)] if route == "fm" else [r]
        return model_lib.forward_from_rows(p, routes[route], rows, None, cfg,
                                           interaction_fn=None if route == "ref" else fn)

    def grads(route):
        w = params["conv"][0]["w"].detach().clone().requires_grad_()
        p = dict(params, conv=[dict(params["conv"][0], w=w)])
        r = rows.clone().requires_grad_()
        loss = (forward(route, p, r) ** 2).sum()
        return torch.autograd.grad(loss, [r, w])

    entry = {"fm": ic.cross_conv1_lin_fm, "bm": ic.cross_conv1_lin}
    with _no_tf32(), torch.no_grad():
        ref = forward("ref", params, rows)
        before = [entry["bm"].launches, entry["fm"].launches]
        got_bm = forward("bm", params, rows)
        got_fm = forward("fm", params, rows)
        fwd_launched = _launched([entry["bm"], entry["fm"]], before, device)
    e_bm = float((got_bm - ref).abs().max())
    e_fm = float((got_fm - ref).abs().max())
    good = e_bm < 1e-3 and e_fm < 1e-3 and fwd_launched
    print(f"interaction fwd err bm={e_bm:.2e} fm={e_fm:.2e} -> {'ok' if good else 'FAIL'}",
          flush=True)

    with _no_tf32():
        gr_r, gr_w = grads("ref")
        scale = float(gr_r.abs().max()) + 1e-9
        w_scale = float(gr_w.abs().max()) + 1e-9
        ok = good
        for route, what in (("fm", "bwd"), ("bm", "bwd(bm full-rows)")):
            before = [entry[route].launches, ic.cross_conv1_bwd.launches]
            g_r, g_w = grads(route)
            launched = _launched([entry[route], ic.cross_conv1_bwd], before, device)
            e_r = float((g_r - gr_r).abs().max())
            e_w = float((g_w - gr_w).abs().max())
            good_b = e_r / scale < 2e-2 and e_w / w_scale < 2e-2 and launched
            print(f"interaction {what} err drows={e_r:.2e} (rel {e_r / scale:.2e}) "
                  f"dw={e_w:.2e} -> {'ok' if good_b else 'FAIL'}", flush=True)
            ok &= good_b
    return ok


def check_embed_lookup(device="cuda") -> bool:
    """Both operands of the field-major lookup against its plain version,
    bit for bit, in every table, id and output dtype it takes."""
    from cffm_tpu_torch.ops import embed_lookup as el

    device = torch.device(device)
    rng = np.random.default_rng(11)
    v, w, b, f, fs = 140_000, 256, 4096, 15, 5
    bounds = tuple(range(0, 64 * fs + 1, 64))
    ids = rng.integers(-50, v + 50, size=(b, f))
    ids[:, :fs] = rng.integers(0, 64 * fs, size=(b, fs))  # about 4 in 5 outside their block
    table = torch.from_numpy(rng.normal(size=(v, w)).astype(np.float32)).to(device)
    ids32 = torch.from_numpy(ids.astype(np.int32)).to(device)
    wide = torch.zeros((b, 2 * f), dtype=torch.int32, device=device)
    wide[:, ::2] = ids32
    ok = True
    for tdt in (torch.float32, torch.bfloat16):
        for name, i in (("int32", ids32), ("int64", ids32.long()), ("strided", wide[:, ::2])):
            for odt in (torch.bfloat16, torch.float32):
                before = [el.lookup_fm.launches]
                got = el.lookup_fm(table.to(tdt), i, bounds, odt)
                want = el.lookup_fm_reference(table.to(tdt), i, bounds, odt)
                good = (all(torch.equal(g.view(torch.int16), x.view(torch.int16))
                            for g, x in zip(got, want))
                        and _launched([el.lookup_fm], before, device))
                print(f"embed_lookup {str(tdt)[6:]} table, {name} ids -> {str(odt)[6:]} "
                      f"-> {'ok' if good else 'FAIL'}", flush=True)
                ok &= good
    return ok


def check_conv_tail_grad(device="cuda") -> bool:
    """A train step's forward and backward through the conv tail's kernels
    against the same step on the CPU, whose tail is the eager chain."""
    from cffm_tpu_torch.config import ModelConfig
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.optim.rowwise import tree_map

    device = torch.device(device)
    f = 15
    cfg = ModelConfig(num_fields=f, vocab_sizes=(32,) * f, embed_dim=16, cross="field_aware",
                      conv_channels=(64, 64), conv_kernel=3, conv_pool=2,
                      compute_dtype="bfloat16", use_first_order=True)
    if not (ic.tail_kernel_takes(cfg) and cfg.fused_linear):
        raise AssertionError("the case needs the fused first-order column and a conv stack "
                             "the tail's kernels take")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    rows = torch.from_numpy((rng.normal(size=(300, f, cfg.table_width)) * 0.3)
                            .astype(np.float32))
    fm = model_lib.Route(full_rows=True, field_major=True, prefix=0)
    fn = ic.make_interaction_fn(use_kernel=True)

    def step(dev):
        p = tree_map(lambda t: t.detach().to(dev), params)
        conv = p["conv"] = tree_map(lambda t: t.requires_grad_(), p["conv"])
        r = rows.to(dev).requires_grad_()
        out = model_lib.forward_from_rows(p, fm, [r.transpose(0, 1)], None, cfg,
                                          interaction_fn=fn)
        leaves = [r] + [t for lay in conv for t in lay.values()]
        return [out.detach()] + list(torch.autograd.grad((out ** 2).sum(), leaves))

    with _no_tf32():
        want = step(torch.device("cpu"))
        before = [ic.conv_tail.launches, ic.conv_tail_bwd.launches]
        got = [t.cpu() for t in step(device)]
        launched = _launched([ic.conv_tail, ic.conv_tail_bwd], before, device)
    names = ["logits", "drows"] + [f"d{n}{i}" for i, lay in enumerate(params["conv"])
                                   for n in lay]
    rel = {n: float((a.float() - b.float()).abs().max()) / (float(b.float().abs().max()) + 1e-9)
           for n, a, b in zip(names, got, want)}
    good = all(v < 2e-2 for v in rel.values()) and launched
    print("conv_tail_grad rel err " + " ".join(f"{n}={v:.2e}" for n, v in rel.items())
          + f" -> {'ok' if good else 'FAIL'}", flush=True)
    return good


CHECKS = (check_sorted_segment, check_streamed_apply, check_interaction_kernel,
          check_embed_lookup, check_conv_tail_grad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this sweep only means something on the card; refusing to "
              "pass on the plain versions", flush=True)
        return 2
    from cffm_tpu_torch.bench import card_line

    ok = True
    for check in CHECKS:
        ok &= check("cuda")
    print(f"card: {card_line()}", flush=True)
    print("ONCHIP PARITY: " + ("OK" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

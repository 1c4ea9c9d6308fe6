"""The scatter experiment (``tools/exp_scatter.py``) held against the JAX
package's ``ops/rasterize.py:_bucketed_scatter_add`` and the port's
``_GatherInstRows`` backward on the CPU.

Inputs are ``exp_scatter.inputs``' seeded numpy draws, handed to both
packages. Bounds: every scatter within ``exp_scatter.REL`` (1e-6) of its
largest magnitude from the float64 sum, the JAX package's forms too, and
the port's against the JAX package's within twice that; the
cumsum-difference form within ``exp_scatter.CUMSUM_REL``; the permutation
scatter and the colliding scatter against the pack's backward bit-equal.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu_torch.ops.rasterize import _gather_inst_rows
from mvs_gaussian_splatting_tpu_torch.tools import exp_scatter as es

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
N, CAP, WIDTH = 1000, 5000, 16


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def jax_scatter(rows, idx, n, fast_rows, widened):
    return jrast._bucketed_scatter_add(rows, idx, n, fast_rows=fast_rows,
                                       widened=widened)


def rel(got, want):
    return es.rel_err(torch.tensor(np.asarray(got)), want)


@pytest.mark.parametrize("widen", [True, False], ids=["widened", "bucketed"])
def test_variants_match_jax(widen):
    rows, idx, perm, gidx = es.inputs(N, CAP, WIDTH, "cpu")
    ref = es.colliding(rows.double(), idx, N)
    jrows, jidx = jnp.asarray(rows.numpy()), jnp.asarray(idx.numpy(),
                                                         jnp.int32)
    form = es.widened if widen else es.bucketed
    for k in es.KS:
        fast_rows = -(-N // k)
        assert -(-N // fast_rows) == k          # the JAX form's K buckets
        want = jax_scatter(jrows, jidx, N, fast_rows, widen)
        got = form(rows, idx, N, k)
        assert rel(want, ref) <= es.REL and es.rel_err(got, ref) <= es.REL
        assert es.rel_err(got, torch.tensor(np.asarray(want)).double()) \
            <= 2 * es.REL
    for fn in (es.colliding, es.colliding_deterministic, es.half_scatters):
        assert es.rel_err(fn(rows, idx, N), ref) <= es.REL, fn.__name__
    assert es.rel_err(es.sort_segment_sum(rows, idx, N), ref) \
        <= es.CUMSUM_REL
    sid, order = torch.sort(idx)
    assert es.rel_err(es.segment_sum_presorted(rows[order], sid, N), ref) \
        <= es.CUMSUM_REL
    assert torch.equal(es.permutation(rows, perm, CAP)[perm], rows)
    assert torch.equal(es.row_gather(rows, gidx), rows[gidx])


def test_colliding_equals_pack_backward():
    """(a) is the scatter of ``_GatherInstRows.backward``, to the bit."""
    rng = np.random.RandomState(3)
    slots = CAP + 128
    table = torch.tensor(rng.rand(N, WIDTH).astype(np.float32),
                         requires_grad=True)
    inst_rank = torch.tensor(rng.randint(0, N, slots).astype(np.int32))
    inst_valid = torch.arange(slots) < CAP - 77
    inst_rank = torch.where(inst_valid, inst_rank, 0)
    g = torch.tensor(rng.randn(WIDTH, slots).astype(np.float32))
    _gather_inst_rows(table, inst_rank, inst_valid).backward(g)
    g_rows = g.masked_fill(~inst_valid[None, :], 0.0).T.contiguous()
    assert torch.equal(table.grad,
                       es.colliding(g_rows, inst_rank.long(), N))


def test_run_cpu():
    """The record at a toy size: every variant and sweep point timed and
    checked."""
    res = es.run("bicycle", iters=1, device="cpu", n=2000, cap=9000,
                 sweep_rows=(500, 4000), sweep_widths=(8, 16))
    assert res["checks"] and all(res["checks"].values()), res["checks"]
    assert set(res["variants"]) == {
        "a_colliding", "a_deterministic", "b_permutation",
        "c_sort_segment_sum", "d_row_gather_2cap", "f_half_scatters",
        "bf16_accumulator", "cumsum_rows_dim0", "cumsum_attribute_major",
        *(f"{f}_k{k}" for f in ("bucketed", "widened") for k in es.KS)}
    recs = [*res["variants"].values(), *res["sweep_rows"],
            *res["sweep_widths"]]
    for rec in recs:
        assert np.isfinite(rec["ms"]) and rec["ns_per_row"] > 0
        assert rec["device_ms"] is None
    assert [r["rows"] for r in res["sweep_rows"]] == [500, 4000]
    assert 0 < res["variants"]["bf16_accumulator"]["rel_err"] < 1e-2
    assert res["card"] is None
    assert es.run("1080p", iters=1, device="cpu", n=300, cap=1200)[
        "sweep_rows"] == []

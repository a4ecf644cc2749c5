"""The fused GIGA step (``ops/giga_step.py``) on the CPU, where its wrappers
run their plain versions: one iteration through them equals one iteration
of ``snnls._giga_step`` + ``_carried_commit`` + the loop's gating bit for
bit, on the states that decide each branch (``tests/giga_step_cases.py``);
whole builds on the fused route equal the plain route's; the route is taken
exactly where its conditions hold; and the step refuses what the kernels
do not take.  The kernels themselves run only on a card
(``tests/test_torch_cuda.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import giga_step_cases as cases
from bayesian_coresets_tpu_torch.ops import giga_select as gs
from bayesian_coresets_tpu_torch.ops import giga_step, snnls

torch.set_num_threads(1)


@pytest.mark.parametrize("name", cases.CASES)
def test_plain_version_equals_the_step(name):
    p, c = cases.case(name)
    ref, none = snnls._iteration(p, cases.clone(c), False)
    assert none is None                               # the CPU takes the plain route
    before = giga_step.launches, giga_step.dirs_launches
    out, work = cases.fused(p, c, plain=False)        # CPU tensors: the plain versions
    assert (giga_step.launches, giga_step.dirs_launches) == before
    cases.assert_same(out, ref)
    cases.assert_case(name, c, out, work)


@pytest.mark.parametrize("segment", [1, 7, 64])
@pytest.mark.parametrize("kind", ["int8", "float32", "bfloat16", "int8_resident"])
def test_builds_on_the_fused_route_equal_the_plain_route(kind, segment, monkeypatch):
    """Up to 150 iterations from a fresh state (the builds latch at 126-145,
    past two refreshes), in segments of 1, 7 and 64: the fused route's
    composition (its directions once a segment, one step per iteration run)
    gives the plain route's state bit for bit."""
    rng = np.random.default_rng(2)
    A = torch.as_tensor(rng.normal(size=(64, 800)).astype(np.float32))
    if kind == "int8_resident":
        from bayesian_coresets_tpu_torch.parallel import quantize_chunk
        q, nrm, bsum = quantize_chunk(A.T.contiguous(), A.shape[1])
        c = snnls.make_consts_quantized(q, nrm, bsum.float())
    else:
        c = snnls.make_consts(A, A.sum(dim=1), select_dtype=getattr(torch, kind))
    s0 = snnls.init_state(c, 256)
    ref = snnls.build(c, s0, 150, cases.TOL, segment=segment)
    steps, iterate = [], giga_step.Step.iterate
    monkeypatch.setattr(snnls, "_fused", lambda p, K: p.method == "giga" and K > 0)
    monkeypatch.setattr(giga_step.Step, "iterate", lambda st: steps.append(1) or iterate(st))
    ran = snnls.itrs_run
    out = snnls.build(c, s0, 150, cases.TOL, segment=segment)
    assert len(steps) == snnls.itrs_run - ran > 120
    cases.assert_same(out, ref, snnls.SNNLSState._fields)
    assert int(out.itr) > 120 and torch.equal(s0.w, torch.zeros_like(s0.w))


def _stand_in(device="cuda", dtype=torch.float32):
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("device,comm,method,K,dtype,fused", [
    ("cuda", None, "giga", 8, torch.float32, True),
    ("cuda", None, "giga", 8, torch.int8, True),
    ("cpu", None, "giga", 8, torch.float32, False),
    ("cuda", object(), "giga", 8, torch.float32, False),
    ("cuda", None, "frankwolfe", 8, torch.float32, False),
    ("cuda", None, "orthopursuit", 8, torch.float32, False),
    ("cuda", None, "importance", 8, torch.float32, False),
    ("cuda", None, "uniform", 8, torch.float32, False),
    ("cuda", None, "giga", 0, torch.float32, False),
    ("cuda", None, "giga", 8, torch.float64, False),
    ("cuda", None, "giga", 8, torch.bfloat16, False),
])
def test_the_fused_route_is_taken_exactly_where_it_applies(device, comm, method, K, dtype, fused):
    """CUDA tensors, unsharded, GIGA, support slots, float32 or int8-resident
    V: the fused route; any one of them missing: the plain route."""
    consts = snnls.SNNLSConsts(_stand_in(device, dtype), *([None] * 6))
    p = snnls._Problem(consts, method, cases.TOL, 1024, comm, None, None, None, None)
    assert snnls._fused(p, K) is fused


@pytest.mark.parametrize("bad", ["V_dtype", "V_stride", "b_shape", "norms_dtype", "xw_dtype",
                                 "w_shape", "no_slots", "idcs_dtype", "device", "done_dtype",
                                 "itr_end_shape", "wscale_shape"])
def test_the_step_refuses_what_the_kernels_do_not_take(bad):
    p, c = cases.case("mid")
    consts = p.consts
    if bad == "V_dtype":
        consts = consts._replace(V=consts.V.double())
    elif bad == "V_stride":
        consts = consts._replace(V=torch.zeros(consts.V.shape[1], consts.V.shape[0]).T)
    elif bad == "b_shape":
        consts = consts._replace(b=consts.b[:-1])
    elif bad == "norms_dtype":
        consts = consts._replace(norms=consts.norms.double())
    elif bad == "xw_dtype":
        c = c._replace(xw=c.xw.double())
    elif bad == "w_shape":
        c = c._replace(w=c.w[:-1])
    elif bad == "no_slots":
        c = c._replace(idcs=c.idcs[:0])
    elif bad == "idcs_dtype":
        c = c._replace(idcs=c.idcs.long())
    elif bad == "device":
        c = c._replace(xw=c.xw.to("meta"))
    elif bad == "done_dtype":
        c = c._replace(done=c.done.int())
    elif bad == "itr_end_shape":
        c = c._replace(itr_end=c.itr_end.view(1))
    else:
        c = c._replace(wscale=c.wscale.view(1))
    with pytest.raises(ValueError):
        giga_step.Step(consts, c, cases.TOL)


@pytest.mark.parametrize("bad", ["none", "idx_dtype", "idx_shape", "score_dtype"])
def test_select_into_writes_the_select_and_refuses_other_buffers(bad):
    p, c = cases.case("mid")
    k, work = p.consts, giga_step.work(c.xw)
    giga_step.directions_ref(k, c, work)
    idx, score = torch.full((1,), -1, dtype=torch.int32), torch.zeros(1)
    if bad == "none":
        gs.giga_select_into(k.Vsel, work.dirs, k.norms, k.valid, idx, score)
        f, s = gs.giga_select_ref(k.Vsel, work.dirs, k.norms, k.valid)
        assert int(idx[0]) == int(f) >= 0 and torch.equal(score[0], s)
        return
    idx = {"idx_dtype": idx.long(), "idx_shape": idx[0]}.get(bad, idx)
    score = score.double() if bad == "score_dtype" else score
    with pytest.raises(ValueError):
        gs.giga_select_into(k.Vsel, work.dirs, k.norms, k.valid, idx, score)


@pytest.mark.parametrize("fused", [False, True])
def test_every_giga_select_goes_through_select_into(fused, monkeypatch):
    """The plain route (through ``giga_select``) and the fused route both
    select through ``giga_select.giga_select_into``, looked up at each call:
    one patch of it sees every select of a build."""
    p, c = cases.case("mid")
    seen, select_into = [], gs.giga_select_into

    def recorded(Vsel, dirs, norms, valid, idx, score):
        select_into(Vsel, dirs, norms, valid, idx, score)
        seen.append(int(idx[0]))

    monkeypatch.setattr(gs, "giga_select_into", recorded)
    if fused:
        monkeypatch.setattr(snnls, "_fused", lambda p, K: p.method == "giga" and K > 0)
    s0 = c.state()
    ran = snnls.itrs_run
    out = snnls.build(p.consts, s0, 20, cases.TOL, segment=7)
    assert len(seen) == snnls.itrs_run - ran >= int(out.itr) - int(s0.itr) > 0
    assert set(out.idcs[:int(out.size)].tolist()) <= set(seen) | set(s0.idcs[:int(s0.size)].tolist())

"""The port's copy of the cycle-level NTT-128 SRM pipeline model
(``repro_torch.core.srm_sim``) against the reference's: the same outputs,
cycle statistics and memory-layout snapshots for the same polynomials,
and the same §IX and Table III analytic models.  A host model in numpy:
no device, exact equality."""
import dataclasses

import numpy as np
import pytest

from repro.core import srm_sim as RS
from repro.core.params import make_ntt_params as r_params

from repro_torch.convert import tensor_to_u32, u32_to_tensor
from repro_torch.core import ntt as TN
from repro_torch.core import srm_sim as TS
from repro_torch.core.params import make_ntt_params as t_params


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("latencies", [(RS.BU_LATENCY, RS.MEM_CLK_TO_Q), (3, 1)])
def test_pipeline_run_equals_reference(k, latencies):
    polys = np.random.default_rng(k).integers(0, t_params(128).q, size=(k, 128),
                                              dtype=np.uint32)
    r_out, r_stats = RS.NTT128Pipeline(r_params(128), *latencies).run(polys)
    t_out, t_stats = TS.NTT128Pipeline(t_params(128), *latencies).run(polys)
    assert t_out.dtype == np.uint32 and np.array_equal(r_out, t_out)
    assert t_stats == r_stats
    # the pipeline computes the port's CG-NTT
    p = t_params(128)
    assert np.array_equal(t_out, tensor_to_u32(TN.ntt_cyclic(u32_to_tensor(polys, "cpu"), p)))


def test_layout_snapshots_equal_reference():
    poly = np.arange(128, dtype=np.uint32)[None]
    r = RS.NTT128Pipeline(r_params(128))
    t = TS.NTT128Pipeline(t_params(128))
    r.run(poly, snapshot_layout=True)
    t.run(poly, snapshot_layout=True)
    for rpe, tpe in zip(r.pes, t.pes):
        assert tpe.layout_snapshots == rpe.layout_snapshots
        assert dataclasses.asdict(tpe.stats) == dataclasses.asdict(rpe.stats)


def test_default_pipeline_is_ntt128():
    assert TS.NTT128Pipeline().p.n == 128 and len(TS.NTT128Pipeline().pes) == 7


@pytest.mark.parametrize("kw", [{}, {"n": 256}, {"bu_latency": 40, "mem_latency": 10}])
def test_table3_model_equals_reference(kw):
    assert TS.table3_model(**kw) == RS.table3_model(**kw)


@pytest.mark.parametrize("kw", [{}, {"k_units": 128}, {"k_units": 8, "flush_cycles": 0}])
def test_large_ntt_cycles_equals_reference(kw):
    assert TS.large_ntt_cycles(**kw) == RS.large_ntt_cycles(**kw)


@pytest.mark.parametrize("kw", [{}, {"n_digits": 4}, {"stage_cycles": 1000}])
def test_keyswitch_cycles_equals_reference(kw):
    assert TS.keyswitch_cycles(**kw) == RS.keyswitch_cycles(**kw)


def test_model_constants_equal_reference():
    assert (TS.CLOCK_GHZ, TS.BU_LATENCY, TS.MEM_CLK_TO_Q) == \
        (RS.CLOCK_GHZ, RS.BU_LATENCY, RS.MEM_CLK_TO_Q)

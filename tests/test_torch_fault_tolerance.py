"""The port's fault tolerance (``repro_torch.distributed.fault_tolerance``)
held to every case of ``tests/test_fault_tolerance.py``, each run on both
packages; and the two packages' elastic plans and recovery actions equal
on the same inputs."""
import dataclasses
import math

import pytest
from _hypothesis_compat import given, settings, st

import repro.distributed.fault_tolerance as ref_ft
import repro_torch.distributed.fault_tolerance as port_ft

PACKAGES = pytest.mark.parametrize("ft", [ref_ft, port_ft],
                                   ids=["reference", "port"])


@PACKAGES
def test_heartbeat_detects_dead(ft):
    hb = ft.HeartbeatMonitor(timeout=5.0)
    hb.beat(0, 0.0)
    hb.beat(1, 0.0)
    hb.beat(0, 8.0)
    assert hb.dead_hosts(10.0) == [1]
    assert hb.alive_hosts(10.0) == [0]


@PACKAGES
def test_straggler_detection(ft):
    sd = ft.StragglerDetector(window=4, ratio=1.5)
    for step in range(6):
        for h in range(4):
            sd.record(h, 1.0 if h != 2 else 2.5)
    assert sd.stragglers() == [2]


@PACKAGES
def test_straggler_robust_to_single_slow_step(ft):
    sd = ft.StragglerDetector(window=8, ratio=1.5)
    for step in range(8):
        for h in range(4):
            sd.record(h, 30.0 if h == 1 and step == 3 else 1.0)
    assert sd.stragglers() == []


@PACKAGES
def test_elastic_remesh_preserves_model_axis(ft):
    plan = ft.plan_elastic_remesh(
        mesh_shape=(2, 16, 16), axis_names=("pod", "data", "model"),
        hosts=list(range(128)), dead=[5], devices_per_host=4,
        global_batch=256)
    assert plan.new_mesh_shape[2] == 16
    assert plan.new_mesh_shape[0] * plan.new_mesh_shape[1] < 32
    assert plan.new_global_batch < 256
    assert 5 in plan.dropped_hosts


@PACKAGES
@given(n_dead=st.integers(1, 60))
@settings(max_examples=20, deadline=None)
def test_elastic_remesh_fits_survivors(ft, n_dead):
    hosts = list(range(64))
    plan = ft.plan_elastic_remesh((16, 16), ("data", "model"), hosts,
                                  hosts[:n_dead], devices_per_host=4,
                                  global_batch=256)
    assert math.prod(plan.new_mesh_shape) <= (64 - n_dead) * 4
    assert plan.new_mesh_shape[1] == 16


@PACKAGES
def test_remesh_impossible_raises(ft):
    with pytest.raises(RuntimeError):
        ft.plan_elastic_remesh((16, 16), ("data", "model"), hosts=[0, 1],
                               dead=[0, 1], devices_per_host=4,
                               global_batch=64)


@PACKAGES
def test_decide_recovery_policies(ft):
    assert ft.decide_recovery([], [], latest_ckpt=5).kind == "none"
    assert ft.decide_recovery([3], [], latest_ckpt=5,
                              spare_hosts=2).kind == "restart"
    assert ft.decide_recovery([3], [], latest_ckpt=5,
                              spare_hosts=0).kind == "remesh"
    with pytest.raises(RuntimeError):
        ft.decide_recovery([3], [], latest_ckpt=None)
    assert ft.decide_recovery([], [7], latest_ckpt=5,
                              spare_hosts=0).kind == "none"


@given(n_dead=st.integers(0, 127), multi=st.booleans(),
       batch=st.sampled_from([1, 64, 256, 1000]),
       per_host=st.sampled_from([1, 4, 8]))
@settings(max_examples=40, deadline=None)
def test_plans_equal_across_packages(n_dead, multi, batch, per_host):
    shape, names = (((2, 16, 16), ("pod", "data", "model")) if multi
                    else ((16, 16), ("data", "model")))
    hosts = list(range(128))
    dead = hosts[::3][:n_dead]
    got = want = None
    try:
        want = dataclasses.asdict(ref_ft.plan_elastic_remesh(
            shape, names, hosts, dead, per_host, batch))
    except RuntimeError as e:
        want = str(e)
    try:
        got = dataclasses.asdict(port_ft.plan_elastic_remesh(
            shape, names, hosts, dead, per_host, batch))
    except RuntimeError as e:
        got = str(e)
    assert got == want


@pytest.mark.parametrize("dead,stragglers,ckpt,spares", [
    ([], [], 5, 0), ([3], [], 5, 2), ([3], [], 5, 0), ([], [7], 5, 0),
    ([], [7], 5, 1), ([1, 2], [3], 9, 1), ([1, 2], [], 0, 2)])
def test_recovery_actions_equal_across_packages(dead, stragglers, ckpt,
                                                spares):
    want = ref_ft.decide_recovery(dead, stragglers, ckpt, spares)
    got = port_ft.decide_recovery(dead, stragglers, ckpt, spares)
    assert (got.kind, got.plan, got.restore_step) == (
        want.kind, want.plan, want.restore_step)

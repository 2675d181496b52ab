"""Port of the replication transport (DESIGN.md §17) held against the JAX
package: every scenario of tests/test_transport.py runs on the port — the
deterministic ones (wire roundtrips, the in-process cursor, the reconcile
over the transport) through both packages with equal observations, the
socket ones held to the reference test's properties, and the converged
socket groups' lookups equal to the reference's (hit masks, regions,
answer ids; sims allclose, atol 1e-5). Across packages: a record encoded
by either decodes in the other to equal arrays, dtypes and stamps; a
reference ``SocketTransport`` and a port one exchange records in order,
with acks, over loopback; ``fetch_state`` works both ways. Every port is
OS-assigned, every wait has a deadline, every transport is closed.
"""
import socket as _socket
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.siso import SISO as JSISO, SISOConfig as JConfig
from repro.distributed import replication as JR
from repro.distributed import transport as JT
from repro.distributed.fault_tolerance import NetworkFaultHooks as JHooks
from repro_torch.core.siso import SISO as PSISO, SISOConfig as PConfig
from repro_torch.distributed import replication as PR
from repro_torch.distributed import transport as PT
from repro_torch.distributed.fault_tolerance import NetworkFaultHooks

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

D = 16
SIM_ATOL = 1e-5
J = SimpleNamespace(R=JR, T=JT, Hooks=JHooks,
                    siso=lambda cfg: JSISO(cfg), Config=JConfig)
P = SimpleNamespace(R=PR, T=PT, Hooks=NetworkFaultHooks,
                    siso=lambda cfg: PSISO(cfg, device="cpu"), Config=PConfig)


def norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def unit(rng, n, d=D):
    return norm(rng.normal(size=(n, d))).astype(np.float32)


def make_siso(pkg, train):
    siso = pkg.siso(pkg.Config(dim=D, answer_dim=D, capacity=64,
                               dynamic_threshold=False, theta_r=0.9,
                               refresh_min=10_000))
    siso.bootstrap(train, train, answer_ids=np.arange(len(train)))
    return siso


class FakeGateway:
    def __init__(self, siso):
        self.frontend = siso
        self.t = 0.0
        self.clock = lambda: self.t

    def drain(self):
        pass


def _record(pkg, origin="a", seq=0, epoch=1, stamp=2.5, n=3):
    rng = np.random.default_rng(seq + 17)
    payload = {
        "centroid_ids": np.arange(4, dtype=np.int64),
        "centroid_access": rng.random(4),
        "spill": {"vectors": rng.random((n, 8)).astype(np.float32),
                  "answers": rng.random((n, 8)).astype(np.float32),
                  "answer_id": np.arange(n, dtype=np.int64) + 100,
                  "cluster_size": np.ones(n)},
        "spill_last_use": rng.random(n)}
    return pkg.R.DeltaRecord(origin=origin, seq=seq, epoch=epoch,
                             stamp=stamp, payload=payload,
                             row_stamps={100 + i: float(i)
                                         for i in range(n)})


def assert_records_equal(rt, rec):
    assert (rt.origin, rt.seq, rt.epoch, rt.stamp, rt.row_stamps) == \
        (rec.origin, rec.seq, rec.epoch, rec.stamp, rec.row_stamps)
    for key in ("centroid_ids", "centroid_access", "spill_last_use"):
        assert rt.payload[key].dtype == rec.payload[key].dtype
        np.testing.assert_array_equal(rt.payload[key], rec.payload[key])
    for key in ("vectors", "answers", "answer_id", "cluster_size"):
        got, want = rt.payload["spill"][key], rec.payload["spill"][key]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def assert_content_equal(r1, r2, ctx=""):
    """Lookup content of independently grown replicas (row indices may
    differ); sims allclose across packages."""
    for f in ("hit", "answer", "answer_id", "region"):
        assert np.array_equal(getattr(r1, f), getattr(r2, f)), (ctx, f)
    np.testing.assert_allclose(r1.sim, r2.sim, atol=SIM_ATOL, err_msg=ctx)


def assert_results_equal(r1, r2, ctx=""):
    for f in ("hit", "sim", "answer", "answer_id", "entry", "region"):
        assert np.array_equal(getattr(r1, f), getattr(r2, f)), (ctx, f)


def _recv(transport, n=1, timeout=10.0):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        rec = transport.next_record()
        if rec is None:
            time.sleep(0.005)
            continue
        transport.ack(rec)
        out.append(rec)
    return out


@contextmanager
def transports(*made):
    try:
        yield made
    finally:
        for t in made:
            t.close()


def socket_pair(a=P, b=P, **kw):
    ta = a.T.SocketTransport("a", a.T.TransportConfig(kind="socket"), **kw)
    tb = b.T.SocketTransport("b", b.T.TransportConfig(kind="socket"), **kw)
    ta.connect("b", tb.address)
    tb.connect("a", ta.address)
    return ta, tb


# ---------------------------------------------------------------------------
# wire format, within and across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc,dec", [(P, P), (J, P), (P, J)],
                         ids=["port", "ref-to-port", "port-to-ref"])
def test_record_roundtrip_preserves_everything(enc, dec):
    rec = _record(enc, seq=3, epoch=7)
    data = enc.T.encode_record(rec)
    assert_records_equal(dec.T.decode_record(data), rec)
    if enc is not dec:      # the same bytes from both encoders
        assert data == dec.T.encode_record(_record(dec, seq=3, epoch=7))


@pytest.mark.parametrize("enc,dec", [(P, P), (J, P), (P, J)],
                         ids=["port", "ref-to-port", "port-to-ref"])
def test_tree_roundtrip_scalars_and_nesting(enc, dec):
    env = {"epoch": 3, "stamps": {"41": 1.5}}
    tree = {"a": np.arange(5), "b": {"c": np.float32(2.5),
                                     "d": [np.ones(2), (np.zeros(3),)]}}
    env2, tree2 = dec.T.decode_tree(enc.T.encode_tree(env, tree))
    assert env2 == env
    np.testing.assert_array_equal(tree2["a"], tree["a"])
    assert float(tree2["b"]["c"]) == 2.5
    assert isinstance(tree2["b"]["d"][1], tuple)
    np.testing.assert_array_equal(tree2["b"]["d"][1][0], np.zeros(3))


@pytest.mark.parametrize("leaf", ["object", "tensor", "bf16 tensor"])
def test_non_numpy_payload_rejected(leaf):
    bad = {"object": np.array([object()], dtype=object),
           "tensor": torch.arange(3.0),
           "bf16 tensor": torch.ones(2, dtype=torch.bfloat16)}[leaf]
    with pytest.raises(TypeError):
        PT.encode_tree({}, {"ok": np.ones(2), "bad": bad})


def test_siso_state_crosses_the_wire_between_packages():
    """A full SISO state (the reconcile payload) written by either package
    decodes in the other and restores there to the same lookups."""
    rng = np.random.default_rng(0)
    train, recorded = unit(rng, 24), unit(rng, 5)
    probe = norm(np.concatenate([train[:3], recorded[:3], unit(rng, 3)])
                 + 0.01 * unit(rng, 9)).astype(np.float32)
    made = []
    for pkg in (J, P):
        s = make_siso(pkg, train)
        for i, v in enumerate(recorded):
            s.record_llm_answer(v, v, answer_id=500 + i)
        made.append(s)
    for (src, s), dst in zip(zip((J, P), made), (P, J)):
        env, state = dst.T.decode_tree(src.T.encode_tree(
            {"origin": "x"}, s.state_dict()))
        assert env == {"origin": "x"}
        fresh = make_siso(dst, unit(np.random.default_rng(9), 24))
        fresh.load_state(state)
        fresh.warm_start()
        want = s.handle_batch(probe.copy())
        assert want.hit[:6].all()
        assert_content_equal(want, fresh.handle_batch(probe.copy()),
                             f"from {'jax' if src is J else 'torch'}")


# ---------------------------------------------------------------------------
# socket delivery (the port), and across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a,b", [(P, P), (J, P), (P, J)],
                         ids=["port", "ref-sends", "port-sends"])
def test_socket_delivers_in_order_and_flushes(a, b):
    with transports(*socket_pair(a, b)) as (ta, tb):
        for s in range(5):
            ta.publish(_record(a, seq=s))
        got = _recv(tb, 5)
        assert [r.seq for r in got] == list(range(5))
        for r, s in zip(got, range(5)):
            assert_records_equal(r, _record(a, seq=s))
        assert ta.flush(10.0), "publisher should see applied-acks"
        st = ta.stats()["peers"]["b"]
        assert st["pending"] == 0 and st["acked_seq"] == 4
        assert tb.stats()["last_applied"]["a"] == 4
        assert not tb.take_gap()


def test_socket_outbox_overflow_drops_and_receiver_reconciles():
    hooks = NetworkFaultHooks()
    cfg = PT.TransportConfig(kind="socket", outbox_cap=4)
    with transports(PT.SocketTransport("a", cfg, hooks=hooks),
                    PT.SocketTransport("b", cfg, hooks=hooks)) as (ta, tb):
        ta.connect("b", tb.address)
        hooks.partition("a", "b")
        for s in range(12):
            ta.publish(_record(P, seq=s))
        assert ta.stats()["peers"]["b"]["outbox_dropped"] >= 8
        hooks.heal()
        got = _recv(tb, 4)
        assert [r.seq for r in got] == [8, 9, 10, 11]
        assert tb.take_gap() and not tb.take_gap()


def test_socket_retry_backoff_until_listener_appears():
    probe = _socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    cfg = PT.TransportConfig(kind="socket", connect_timeout_s=0.2,
                             backoff_base_s=0.02, backoff_max_s=0.1)
    ta = PT.SocketTransport("a", cfg)
    tb = None
    try:
        ta.connect("b", ("127.0.0.1", port))
        ta.publish(_record(P, seq=0))
        deadline = time.monotonic() + 5.0
        while ta.stats()["peers"]["b"]["retries"] < 2:
            assert time.monotonic() < deadline, "no connect retries seen"
            time.sleep(0.01)
        tb = PT.SocketTransport("b", PT.TransportConfig(kind="socket",
                                                        port=port))
        got = _recv(tb, 1)
        assert got and got[0].seq == 0
        assert ta.stats()["peers"]["b"]["backoffs"] >= 2
    finally:
        ta.close()
        if tb is not None:
            tb.close()


def test_socket_injected_drop_creates_gap():
    hooks = NetworkFaultHooks(drop_every=2)
    cfg = PT.TransportConfig(kind="socket")
    with transports(PT.SocketTransport("a", cfg, hooks=hooks),
                    PT.SocketTransport("b", cfg, hooks=hooks)) as (ta, tb):
        ta.connect("b", tb.address)
        for s in range(6):
            ta.publish(_record(P, seq=s))
        got = _recv(tb, 3)
        assert [r.seq for r in got] == [0, 2, 4]
        assert ta.flush(10.0)
        assert hooks.dropped == 3 and tb.take_gap()


def test_adopt_acks_superseded_inbox():
    with transports(*socket_pair()) as (ta, tb):
        for s in range(4):
            ta.publish(_record(P, seq=s))
        deadline = time.monotonic() + 10.0
        while tb.stats()["inbox_depth"] < 4 and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        assert tb.stats()["inbox_depth"] == 4
        tb.adopt({"a": 4})
        assert tb.next_record() is None
        assert ta.flush(10.0), "adopt must ack what it discards"


def test_reconnect_restores_ack_watermark():
    with transports(*socket_pair()) as (ta, tb):
        for s in range(3):
            ta.publish(_record(P, seq=s))
        assert len(_recv(tb, 3)) == 3
        assert ta.flush(10.0)
        peer = ta._peers["b"]
        with peer.cv:
            ta._drop_conn(peer)
            peer.acked = -1
        assert ta.flush(10.0), "idle reconnect must restore the watermark"


@pytest.mark.parametrize("a,b", [(P, P), (J, P), (P, J)],
                         ids=["port", "ref-donor", "port-donor"])
def test_fetch_state_roundtrip(a, b):
    """``tb`` fetches ``ta``'s state: within the port and across."""
    with transports(*socket_pair(a, b)) as (ta, tb):
        ta.state_provider = lambda: ({"origin": "a", "epoch": 4,
                                      "stamps": {"9": 1.0}, "cursor": {}},
                                     {"w": np.arange(6.0),
                                      "n": [np.int64(3), (np.ones(2),)]})
        env, state = tb.fetch_state("a", timeout_s=10.0)
        assert env["origin"] == "a" and env["epoch"] == 4
        np.testing.assert_array_equal(state["w"], np.arange(6.0))
        assert int(state["n"][0]) == 3 and isinstance(state["n"][1], tuple)


def test_fetch_state_times_out_without_provider():
    with transports(*socket_pair()) as (ta, tb):
        assert tb.fetch_state("a", timeout_s=0.3) is None


# ---------------------------------------------------------------------------
# the replica plane over sockets
# ---------------------------------------------------------------------------


def _socket_group(pkg, n=2, hooks=None):
    train = unit(np.random.default_rng(0), 24)
    cfg = pkg.R.ReplicationConfig(
        apply_budget=64, transport=pkg.T.TransportConfig(kind="socket"))
    group = pkg.R.ReplicaGroup(cfg, fault_hooks=hooks)
    reps = [group.add(chr(ord("a") + i), FakeGateway(make_siso(pkg, train)))
            for i in range(n)]
    return group, reps


def _socket_converges(pkg):
    rng = np.random.default_rng(1)
    group, (ra, rb) = _socket_group(pkg)
    fa, fb = ra.gw.frontend, rb.gw.frontend
    try:
        for i, v in enumerate(unit(rng, 6)):
            (fa if i % 2 else fb).record_llm_answer(v, v, answer_id=200 + i)
        group.sync_all(1.0, timeout_s=30.0)
        assert group.barrier(30.0)
        probe = norm(np.concatenate([fa.cache.spill.vectors[:4],
                                     unit(rng, 4)])).astype(np.float32)
        res = fa.handle_batch(probe.copy())
        assert_content_equal(res, fb.handle_batch(probe.copy()), "pair")
        assert ra.merged_rows >= 1 and rb.merged_rows >= 1
        return res, (ra.merged_rows, rb.merged_rows)
    finally:
        group.close()


def test_socket_group_replicates_and_converges():
    ref, ref_rows = _socket_converges(J)
    out, rows = _socket_converges(P)
    assert_content_equal(ref, out, "port vs reference")
    assert rows == ref_rows


def _socket_faults(pkg):
    rng = np.random.default_rng(2)
    hooks = pkg.Hooks(delay_s=0.002, drop_every=3)
    group, reps = _socket_group(pkg, n=3, hooks=hooks)
    try:
        hooks.partition("a", "b")
        for i, v in enumerate(unit(rng, 12)):
            rep = reps[i % 3]
            rep.gw.frontend.record_llm_answer(v, v, answer_id=300 + i)
            rep.publish(float(i))
        hooks.heal()
        assert group.barrier(60.0), "group did not settle under faults"
        assert hooks.dropped > 0
        assert sum(r.gap_reconciles for r in reps) > 0
        fa = reps[0].gw.frontend
        probe = norm(np.concatenate([fa.cache.spill.vectors[:4],
                                     fa.cache.centroids.vectors[:4],
                                     unit(rng, 4)])).astype(np.float32)
        want = fa.handle_batch(probe.copy())
        for rep in reps[1:]:
            assert_content_equal(want, rep.gw.frontend.handle_batch(
                probe.copy()), f"faulted convergence {rep.name}")
        donor = group.donor_for(reps[0]) or reps[0]
        for rep in reps:
            if rep is not donor:
                assert group.reconcile(rep)
        want = donor.gw.frontend.handle_batch(probe.copy())
        for rep in reps:
            if rep is not donor:
                assert_results_equal(want, rep.gw.frontend.handle_batch(
                    probe.copy()), f"post-reconcile {rep.name}")
        return want
    finally:
        group.close()


def test_socket_group_converges_under_faults():
    """Both packages converge under the same faults; which records the
    drops hit depends on thread timing, so the converged lookups are held
    to each other only where the content is the whole history."""
    ref = _socket_faults(J)
    out = _socket_faults(P)
    assert out.hit.sum() == ref.hit.sum()


def _remote_reconcile(pkg):
    rng = np.random.default_rng(3)
    train = unit(rng, 24)
    cfg = pkg.T.TransportConfig(kind="socket")
    ta = pkg.T.SocketTransport("a", cfg)
    tb = pkg.T.SocketTransport("b", cfg)
    ra = pkg.R.Replica("a", FakeGateway(make_siso(pkg, train)), ta)
    rb = pkg.R.Replica("b", FakeGateway(make_siso(pkg, train)), tb)
    ta.state_provider = lambda: ra._reconcile_payload(copy=False)
    tb.state_provider = lambda: rb._reconcile_payload(copy=False)
    ta.connect("b", tb.address)
    tb.connect("a", ta.address)
    fa, fb = ra.gw.frontend, rb.gw.frontend
    try:
        fa.record_llm_answer(*(unit(rng, 1)[0],) * 2, answer_id=700)
        fa.refresh()
        ra.publish(1.0)
        deadline = time.monotonic() + 30.0
        while rb.reconciles == 0 and time.monotonic() < deadline:
            rb.apply_pending(None)
            time.sleep(0.01)
        assert rb.reconciles == 1
        assert fb.refresh_epoch == fa.refresh_epoch
        probe = norm(np.concatenate([fa.cache.centroids.vectors[:4],
                                     unit(rng, 4)])).astype(np.float32)
        res = fa.handle_batch(probe.copy())
        assert_results_equal(res, fb.handle_batch(probe.copy()), "remote")
        return res, fb.refresh_epoch, rb._stamps
    finally:
        ra.close()
        rb.close()


def test_remote_reconcile_over_transport():
    (r_ref, e_ref, s_ref) = _remote_reconcile(J)
    (r_out, e_out, s_out) = _remote_reconcile(P)
    for f in ("hit", "answer", "answer_id", "entry", "region"):
        np.testing.assert_array_equal(getattr(r_ref, f), getattr(r_out, f))
    np.testing.assert_allclose(r_ref.sim, r_out.sim, atol=SIM_ATOL)
    assert (e_ref, s_ref) == (e_out, s_out)


def test_reconcile_across_packages_over_the_wire():
    """A port replica lagging behind a reference replica fetches its state
    over one socket link and then serves as it does."""
    rng = np.random.default_rng(4)
    train = unit(rng, 24)
    ta = JT.SocketTransport("a", JT.TransportConfig(kind="socket"))
    tb = PT.SocketTransport("b", PT.TransportConfig(kind="socket"))
    ra = JR.Replica("a", FakeGateway(make_siso(J, train)), ta)
    rb = PR.Replica("b", FakeGateway(make_siso(P, train)), tb)
    ta.state_provider = lambda: ra._reconcile_payload(copy=False)
    ta.connect("b", tb.address)
    tb.connect("a", ta.address)
    try:
        fa, fb = ra.gw.frontend, rb.gw.frontend
        for i, v in enumerate(unit(rng, 4)):
            fa.record_llm_answer(v, v, answer_id=800 + i)
        fa.refresh()
        ra.publish(1.0)
        deadline = time.monotonic() + 30.0
        while rb.reconciles == 0 and time.monotonic() < deadline:
            rb.apply_pending(None)
            time.sleep(0.01)
        assert rb.reconciles == 1 and fb.refresh_epoch == fa.refresh_epoch
        probe = norm(np.concatenate([fa.cache.centroids.vectors[:6],
                                     unit(rng, 4)])).astype(np.float32)
        r1, r2 = fa.handle_batch(probe.copy()), fb.handle_batch(probe.copy())
        for f in ("hit", "answer", "answer_id", "entry", "region"):
            np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
        np.testing.assert_allclose(r1.sim, r2.sim, atol=SIM_ATOL)
        assert r1.hit.any()
    finally:
        ra.close()
        rb.close()


def _inproc_round_robin(pkg):
    log = pkg.R.ReplicationLog()
    ta = pkg.T.InProcessTransport(log, "a")
    tb = pkg.T.InProcessTransport(log, "b")
    for s in range(3):
        ta.publish(_record(pkg, origin="a", seq=s))
    assert ta.next_record() is None
    assert ta.position() == 3
    got = [tb.next_record().seq for _ in range(3)]
    assert got == [0, 1, 2] and tb.next_record() is None
    return got, ta.stats(), tb.stats(), tb.peers()


def test_inproc_transport_round_robin_matches_log():
    assert _inproc_round_robin(P) == _inproc_round_robin(J)

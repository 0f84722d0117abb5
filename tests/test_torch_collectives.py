"""Port vs reference: the collectives (``distributed/collectives.py``) and
fault tolerance (``distributed/fault_tolerance.py``).

The reference's collectives run on a one-device JAX mesh here; the port's
on meshes of the CPU repeated.  Integer reductions must be equal bit for
bit; the int8 quantization is float32 IEEE arithmetic in the same order
on both sides, so it must be too.  On n shards the int8 all-reduce equals
the closed form that the reference's own quantize/dequantize give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.distributed import collectives as J
from repro.distributed import fault_tolerance as JF
from repro_torch.distributed import collectives as T
from repro_torch.distributed import fault_tolerance as TF
from repro_torch.launch.mesh import DeviceMesh, make_test_mesh


def _deltas(b=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-2, 3, (b, 12, 34)).astype(np.int32),
            rng.integers(-1, 2, (b, 10, 12)).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jmesh(axis):
    return Mesh(np.array(jax.devices()[:1]), (axis,))


def test_tree_psum_batch_without_mesh_equals_reference():
    ta, w = _deltas()
    want = J.tree_psum_batch((jnp.asarray(ta), jnp.asarray(w)))
    got = T.tree_psum_batch((_t(ta), _t(w)))
    for g, j in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_tree_psum_batch_on_a_mesh_equals_reference(n):
    """The meshed reduction equals the reference on its one-device mesh
    (and so the unsharded sum), for any shard count that divides B."""
    ta, w = _deltas(seed=n)
    want = J.tree_psum_batch((jnp.asarray(ta), jnp.asarray(w)), mesh=_jmesh("data"),
                             axis="data")
    got = T.tree_psum_batch({"ta": _t(ta), "w": (_t(w),)}, mesh=make_test_mesh(n, 1))
    np.testing.assert_array_equal(got["ta"].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got["w"][0].numpy(), np.asarray(want[1]))


def test_tree_psum_batch_takes_per_shard_blocks_and_refuses_ragged_batches():
    ta, w = _deltas(seed=5)
    mesh = DeviceMesh(["cpu"] * 4, ("data",))
    blocks = [_t(ta[i * 4:(i + 1) * 4]).to(torch.int8) for i in range(4)]
    got_ta, got_w = T.tree_psum_batch((blocks, _t(w)), mesh=mesh)
    assert got_ta.dtype == torch.int32
    np.testing.assert_array_equal(got_ta.numpy(), ta.sum(0))
    np.testing.assert_array_equal(got_w.numpy(), w.sum(0))
    with pytest.raises(ValueError, match="does not divide"):
        T.tree_psum_batch(_t(ta[:15]), mesh=mesh)
    with pytest.raises(ValueError, match="3 row blocks for 4 shards"):
        T.tree_psum_batch(blocks[:3], mesh=mesh)


def test_psum_tree_is_exact_and_replicated():
    rng = np.random.default_rng(1)
    parts = [(_t(rng.integers(-1000, 1000, (6, 5)).astype(np.int32)),) for _ in range(3)]
    out = T.psum_tree(parts)
    want = sum(p[0].numpy() for p in parts)
    assert len(out) == 3 and out[0] is out[1] is out[2]     # one device: one copy
    np.testing.assert_array_equal(out[0][0].numpy(), want)


@pytest.mark.parametrize("seed,scale", [(0, 1e-6), (1, 1e-3), (2, 1.0), (3, 1e3),
                                        (4, 3.7e-2), (5, 250.0)])
@pytest.mark.parametrize("n", [1000, 2048, 5000])
def test_quantize_dequantize_bit_equal_to_reference(seed, scale, n):
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)
    qj, sj = J.quantize_int8(jnp.asarray(x))
    qt, st = T.quantize_int8(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    yj = J.dequantize_int8(qj, sj, x.shape, jnp.float32)
    yt = T.dequantize_int8(qt, st, x.shape, torch.float32)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_quantize_floors_the_scale_of_a_zero_block():
    q, s = T.quantize_int8(torch.zeros(3000))
    assert not q.any() and float(s.min()) == np.float32(1e-12)


def test_compressed_grad_sync_bit_equal_to_reference_over_steps():
    rng = np.random.default_rng(0)
    grads = [{"w": (rng.standard_normal(256) * 1e-3).astype(np.float32),
              "b": (rng.standard_normal((3, 1500)) * 10).astype(np.float32)}
             for _ in range(10)]
    jres = {"w": jnp.zeros(256, jnp.float32), "b": jnp.zeros((3, 1500), jnp.float32)}
    tres = {"w": torch.zeros(256), "b": torch.zeros((3, 1500))}
    for g in grads:
        jsent, jres = J.compressed_grad_sync({k: jnp.asarray(v) for k, v in g.items()}, jres)
        tsent, tres = T.compressed_grad_sync({k: _t(v) for k, v in g.items()}, tres)
        for k in g:
            np.testing.assert_array_equal(tsent[k].numpy(), np.asarray(jsent[k]))
            np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))


def test_int8_psum_one_device_equals_reference():
    x = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    want = J.int8_psum_shard_map(jnp.asarray(x), _jmesh("pod"), axis="pod")
    got = T.int8_psum_shard_map(_t(x), DeviceMesh(["cpu"], ("pod",)), axis="pod")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [2, 4])
def test_int8_psum_n_devices_equals_reference_closed_form(n):
    """A replicated input over n shards: every shard's scale is the shared
    maximum, so the result is ``dequantize(n * q, s)`` in the reference's
    own functions."""
    x = np.random.default_rng(n).standard_normal((64, 64)).astype(np.float32)
    got = T.int8_psum_shard_map(_t(x), DeviceMesh(["cpu"] * n, ("pod",)), axis="pod")
    q, s = J.quantize_int8(jnp.asarray(x))
    want = J.dequantize_int8(n * q.astype(jnp.int32), s, x.shape, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(np.abs(got.numpy() - n * x).max() / np.abs(n * x).max()) < 0.02


def test_int8_psum_distinct_contributions_share_the_largest_scale():
    rng = np.random.default_rng(7)
    parts = [rng.standard_normal(4096).astype(np.float32) * s for s in (1.0, 3.0)]
    got = T.int8_psum_shard_map([_t(p) for p in parts], DeviceMesh(["cpu"] * 2, ("pod",)))
    qs = [J.quantize_int8(jnp.asarray(p)) for p in parts]
    s_max = jnp.maximum(qs[0][1], qs[1][1])
    tot = sum(jnp.round(q.astype(jnp.float32) * (s / s_max)).astype(jnp.int32)
              for q, s in qs)
    want = J.dequantize_int8(tot, s_max, parts[0].shape, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- fault tolerance: the same sequences through both packages -------------

@pytest.mark.parametrize("durations", [
    [1.0] * 16 + [10.0] * 3 + [2.0] * 16 + [20.0] * 3,
    [1.0] * 16 + [10.0, 1.0, 10.0, 10.0, 10.0, 10.0],
    [0.5, 0.6, 3.0, 0.4, 5.0, 5.0, 5.0, 0.5] * 6,
])
def test_straggler_policy_same_decisions(durations):
    jp = JF.StragglerPolicy(factor=3.0, window=16, tolerance=3)
    tp = TF.StragglerPolicy(factor=3.0, window=16, tolerance=3)
    for d in durations:
        assert tp.observe(d) == jp.observe(d)
        assert tp.median == jp.median


def test_heartbeat_same_dead_hosts():
    mons = [m.HeartbeatMonitor(timeout=10.0) for m in (JF, TF)]
    script = [("expect", ["h0", "h1", "h2"], 0.0), ("beat", "h0", 8.0), ("beat", "h1", 8.0),
              ("dead", None, 12.0), ("expect", ["h0", "h1", "h2", "h3"], 12.0),
              ("dead", None, 17.0), ("beat", "h2", 18.0), ("dead", None, 23.0)]
    for op, arg, now in script:
        outs = []
        for mon in mons:
            if op == "expect":
                outs.append(mon.expect(arg, now=now))
            elif op == "beat":
                outs.append(mon.beat(arg, now=now))
            else:
                outs.append((mon.dead_hosts(now=now), mon.healthy(now=now)))
        assert outs[0] == outs[1], (op, now)


def _restart_run(mod, failures, restore_failures, total, every, max_restarts):
    """One run_with_restarts with scripted step and restore failures; the
    returned stats (or the error), the saves and the hooks' calls."""
    state = {"ckpt": 0, "restores": 0, "saves": [], "hooks": 0}
    failed = set()

    def step_fn(step):
        if step in failures and (step not in failed or failures[step] == "always"):
            failed.add(step)
            raise RuntimeError(f"step {step}")

    def save_fn(step):
        state["ckpt"] = step
        state["saves"].append(step)

    def restore_fn():
        state["restores"] += 1
        if state["restores"] in restore_failures:
            raise OSError("restore")
        return state["ckpt"]

    def on_restart(err):
        state["hooks"] += 1

    try:
        st = mod.run_with_restarts(step_fn, start_step=0, total_steps=total, save_fn=save_fn,
                                   restore_fn=restore_fn, checkpoint_every=every,
                                   max_restarts=max_restarts, on_restart=on_restart)
        out = (st.restarts, st.completed_steps, st.resumed_from)
    except (RuntimeError, OSError) as e:
        out = (type(e).__name__, str(e))
    return out, state


@pytest.mark.parametrize("failures,restore_failures,total,every,max_restarts", [
    ({5: "once"}, (), 10, 2, 2),
    ({5: "once", 15: "once", 25: "once", 35: "once"}, (), 40, 2, 1),
    ({6: "always"}, (), 10, 2, 3),
    ({3: "once"}, (1,), 6, 2, 3),
    ({0: "always"}, (1, 2, 3, 4), 5, 10, 3),
])
def test_run_with_restarts_same_returns_and_stats(failures, restore_failures, total, every,
                                                  max_restarts):
    want = _restart_run(JF, failures, restore_failures, total, every, max_restarts)
    got = _restart_run(TF, failures, restore_failures, total, every, max_restarts)
    assert got == want

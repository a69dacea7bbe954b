"""The port's training utilities against the JAX package on the CPU: the
learning-rate schedules, global-norm clipping, gradient accumulation over
microbatches, the int8 error-feedback round trip and ``compressed_psum``
(one replica against JAX's ``axis_name=None`` path; a 2-process gloo world
against the numpy form of JAX's psum, pmax and divide), and the data
pipeline (``PrefetchIterator``'s order and errors, ``shard_batches`` at
world 1 against JAX's on a 1-device mesh and at world 2). Tolerances per
test; the quantized payloads are held exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.data import pipeline as jpipe
from repro.optim import grad_utils as jgu
from repro.optim import schedules as jsched
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import grad_utils as tgu
from repro_torch.optim import schedules as tsched

from torch_world import World


@pytest.fixture(scope="module")
def world():
    w = World(2)
    yield w
    w.close()


def _np(t):
    return {k: _np(v) for k, v in t.items()} if isinstance(t, dict) \
        else (t.detach().numpy() if isinstance(t, torch.Tensor)
              else np.asarray(t))


def _torch(t):
    return {k: _torch(v) for k, v in t.items()} if isinstance(t, dict) \
        else torch.from_numpy(np.array(t))


def _jnp(t):
    return jax.tree.map(jnp.asarray, t)


def _close(got, want, tol):
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], tol)
        else:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       atol=tol, rtol=tol, err_msg=k)


def _grads(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.normal(size=(7, 5)) * scale).astype(np.float32),
                  "b": (rng.normal(size=(5,)) * scale).astype(np.float32)},
            "z": (rng.normal(size=(3, 4, 2)) * 3 * scale).astype(np.float32)}


# --------------------------------------------------------- schedules --
WARM, TOTAL = 10, 50
SCHEDULES = [
    ("constant", lambda m: m.constant(3e-4)),
    ("warmup_cosine", lambda m: m.linear_warmup_cosine(3e-4, WARM, TOTAL)),
    ("warmup_cosine_floor",
     lambda m: m.linear_warmup_cosine(1e-3, WARM, TOTAL, floor=1e-5)),
    ("inverse_sqrt", lambda m: m.inverse_sqrt(1e-3, WARM)),
]


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_jax(name, make):
    """At counts 0, warmup - 1, warmup, total and past total (1e-6); a
    float32 0-d tensor on the count's device."""
    jfn, tfn = make(jsched), make(tsched)
    for c in (0, 1, WARM - 1, WARM, WARM + 1, 30, TOTAL, TOTAL + 7):
        got = tfn(torch.tensor(c, dtype=torch.int32))
        want = jfn(jnp.asarray(c, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=1e-12, err_msg=f"{name} at {c}")


# ------------------------------------------------------- grad utils --
@pytest.mark.parametrize("scale", [0.01, 1.0, 40.0])
def test_global_norm_and_clip_match_jax(scale):
    """Below and above the clip norm: the norm and clipped leaves 1e-6."""
    g = _grads(1, scale)
    np.testing.assert_allclose(float(tgu.global_norm(_torch(g))),
                               float(jgu.global_norm(_jnp(g))), rtol=1e-6)
    got, gn = tgu.clip_by_global_norm(_torch(g), 1.0)
    want, jn = jgu.clip_by_global_norm(_jnp(g), 1.0)
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    _close(got, want, 1e-6)


def _mlp_loss(lib):
    """A two-layer tanh regression loss over a nested params tree, written
    once for either array library."""
    def loss(p, b):
        h = lib.tanh(b["x"] @ p["l1"]["w"] + p["l1"]["b"])
        return ((h @ p["l2"] - b["y"]) ** 2).mean()
    return loss


@pytest.mark.parametrize("micro", [1, 2, 4])
def test_accumulate_gradients_matches_jax(micro):
    """1, 2 and 4 microbatches of a batch of 8: the mean loss and grads
    (1e-6), against JAX's scan over the same microbatches."""
    rng = np.random.default_rng(2)
    params = {"l1": {"w": rng.normal(size=(6, 5)).astype(np.float32),
                     "b": rng.normal(size=(5,)).astype(np.float32)},
              "l2": rng.normal(size=(5, 3)).astype(np.float32)}
    batch = {"x": rng.normal(size=(8, 6)).astype(np.float32),
             "y": rng.normal(size=(8, 3)).astype(np.float32)}
    jl, jg = jgu.accumulate_gradients(_mlp_loss(jnp), _jnp(params),
                                      _jnp(batch), micro)
    tp = _torch(params)
    tl, tg = tgu.accumulate_gradients(_mlp_loss(torch), tp, _torch(batch),
                                      micro)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6, atol=1e-7)
    _close(tg, jg, 1e-6)
    assert all(not p.requires_grad for p in (tp["l1"]["w"], tp["l2"]))


def test_int8_round_trip_equals_jax():
    """``quantize_int8`` gives JAX's int8 payload exactly and its scale;
    ``dequantize_int8`` its values."""
    for seed, scale in ((0, 1.0), (1, 1e-4), (2, 300.0)):
        x = _grads(seed, scale)["z"]
        q, s = tgu.quantize_int8(torch.from_numpy(x))
        jq, js = jgu.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        assert np.array_equal(tgu.dequantize_int8(q, s).numpy(),
                              np.asarray(jgu.dequantize_int8(jq, js)))


def test_compressed_psum_one_replica_equals_jax():
    """Three error-feedback steps with ``group=None`` against JAX's
    ``axis_name=None``: the grads and residuals equal."""
    tres = tgu.init_error_feedback(_torch(_grads(0)))
    jres = jgu.init_error_feedback(_jnp(_grads(0)))
    for step in range(3):
        g = _grads(10 + step)
        tout, tres = tgu.compressed_psum(_torch(g), tres)
        jout, jres = jgu.compressed_psum(_jnp(g), jres)
        _close(tout, jout, 0)
        _close(tres, jres, 0)


def _numpy_psum(grads_by_rank, res_by_rank):
    """The numpy form of JAX's axis path: each rank's payload by JAX's
    ``quantize_int8``, their int32 sum, the largest scale, the division by
    the replica count; each rank's residual at that scale."""
    size = len(grads_by_rank)

    def one(gs, rs):
        g32 = [g.astype(np.float32) + r for g, r in zip(gs, rs)]
        qs = [jgu.quantize_int8(jnp.asarray(x)) for x in g32]
        qsum = sum(np.asarray(q).astype(np.int32) for q, _ in qs)
        scale = np.float32(max(float(s) for _, s in qs))
        deq = (qsum.astype(np.float32) * scale) / np.float32(size)
        res = [x - np.asarray(q).astype(np.float32) * scale
               for x, (q, _) in zip(g32, qs)]
        return deq, res

    def walk(gs, rs):
        out = {}
        for k in gs[0]:
            if isinstance(gs[0][k], dict):
                out[k] = walk([g[k] for g in gs], [r[k] for r in rs])
            else:
                out[k] = one([g[k] for g in gs], [r[k] for r in rs])
        return out
    return walk(grads_by_rank, res_by_rank)


def test_compressed_psum_in_a_world_of_two(world):
    """Two ranks with different grads and residuals: both get the mean of
    the dequantized int32 sum at the larger scale, and each its own
    residual, equal to the numpy form of JAX's psum / pmax / divide."""
    grads = [_grads(20), _grads(21, 4.0)]
    res = [jax.tree.map(lambda x: (x * 1e-3).astype(np.float32),
                        _grads(30 + r)) for r in range(2)]
    out = world.run("torch_world:compressed_psum", grads, res)
    want = _numpy_psum(grads, res)

    def check(got, want, r):
        for k, w in want.items():
            if isinstance(w, dict):
                check((got[0][k], got[1][k]), w, r)
            else:
                deq, rs = w
                np.testing.assert_array_equal(got[0][k], deq, err_msg=k)
                np.testing.assert_allclose(got[1][k], rs[r], rtol=0,
                                           atol=1e-7, err_msg=k)
    for r, got in enumerate(out):
        check(got, want, r)


# --------------------------------------------------------- pipeline --
def test_prefetch_iterator_keeps_order_and_raises():
    assert list(tpipe.PrefetchIterator(iter(range(50)), prefetch=3)) == \
        list(range(50))

    def failing():
        yield from range(4)
        raise ValueError("source broke")
    it = tpipe.PrefetchIterator(failing(), prefetch=2)
    assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="source broke"):
        next(it)


def _host_batches(n=3, rows=8):
    rng = np.random.default_rng(4)
    return [{"tokens": rng.integers(0, 100, (rows, 5)).astype(np.int32),
             "labels": rng.integers(0, 100, (rows, 5)).astype(np.int32),
             "step": np.int32(i)} for i in range(n)]


def test_shard_batches_world_one_matches_jax():
    """World 1: every batch whole and in order, as JAX's ``shard_batches``
    on a 1-device ``data`` mesh gives it."""
    batches = _host_batches()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = list(jpipe.shard_batches(iter(batches), mesh))
    got = list(tpipe.shard_batches(iter(batches), "cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == \
                "cpu"
            assert np.array_equal(g[k].numpy(), np.asarray(w[k])), k
    with pytest.raises(ValueError, match="does not split"):
        list(tpipe.shard_batches(iter(_host_batches(1, rows=7)), "cpu",
                                 rank=0, world=2))


def test_shard_batches_world_two(world):
    """World 2: rank r gets rows [4r, 4r + 4) of each batch of 8, in order;
    0-d arrays whole."""
    batches = _host_batches()
    out = world.run("torch_world:sharded_batches", batches)
    for r, got in enumerate(out):
        assert len(got) == 3
        for g, b in zip(got, batches):
            for k in ("tokens", "labels"):
                assert np.array_equal(g[k], b[k][4 * r:4 * r + 4])
            assert g["step"] == b["step"]

"""Port's threefry2x32 against jax.random, bit for bit (CPU), and the
threefry2x32 kernel against its plain version.

The ``cuda`` tests run on a machine with a card, which has no JAX; there
the JAX imports below are absent and only those tests are selected::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_random.py
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.core.walk import walker_key as jax_walker_key
except ImportError:     # the card's machine: the cuda tests need no JAX
    jax = jnp = jax_walker_key = None

from repro_torch import random as jr
from repro_torch.kernels import threefry as TF
from repro_torch.convert import key_from_numpy
from repro_torch.core.walk import step_uniforms, walker_key

SEEDS = [0, 1, 11, 5, 7000024, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 33 + 5, -3]


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split_uniform(seed):
    jk = jax.random.PRNGKey(seed)
    tk = jr.PRNGKey(seed)
    assert np.array_equal(tk.numpy(), _np(jk))
    data = np.array([0, 1, 7, 255, 65536, 2 ** 31 - 1], np.int64)
    want = np.stack([_np(jax.random.fold_in(jk, int(d))) for d in data])
    assert np.array_equal(jr.fold_in(tk, torch.from_numpy(data)).numpy(),
                          want)
    assert np.array_equal(jr.split(tk).numpy(), _np(jax.random.split(jk)))
    assert np.array_equal(jr.split(tk, 3).numpy(),
                          _np(jax.random.split(jk, 3)))
    assert jr.uniform(tk).numpy() == np.asarray(jax.random.uniform(jk))


def test_uniform_bits_over_many_keys():
    """uniform's float construction (bits >> 9 | 0x3F800000, minus 1)
    over 4,096 keys, batched against a vmapped jax.random.uniform."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, (4096, 2), dtype=np.uint64) \
        .astype(np.uint32)
    want = np.asarray(jax.vmap(jax.random.uniform)(jnp.asarray(keys)))
    got = jr.uniform(torch.from_numpy(keys.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, 1000003])
def test_walker_keys_and_step_uniforms(seed):
    """Per-(walker, step) keys and the exact draw's uniforms over a sweep
    of walker ids and steps, as core/walk.py and engine/sampler.py make
    them in the JAX package."""
    ids = np.array([0, 1, 2, 17, 255, 4095, 2 ** 31 - 1], np.int32)
    steps = np.arange(0, 9, dtype=np.int32)
    jk = jax.random.PRNGKey(seed)
    want = np.asarray(jax.vmap(lambda i: jax.vmap(
        lambda s: jax_walker_key(jk, i, s))(steps))(jnp.asarray(ids)))
    tk = jr.PRNGKey(seed)
    got = walker_key(tk, torch.from_numpy(ids).long()[:, None],
                     torch.from_numpy(steps).long()[None, :])
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    want_u = np.asarray(jax.vmap(lambda i: jax.vmap(
        lambda s: jax.random.uniform(jax.random.split(
            jax_walker_key(jk, i, s))[0]))(steps[1:]))(jnp.asarray(ids)))
    got_u = step_uniforms(tk, torch.from_numpy(ids).long(), len(steps))
    assert np.array_equal(got_u.numpy(), want_u)


def test_key_from_numpy():
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 123)
    tk = key_from_numpy(np.asarray(jk))
    assert np.array_equal(tk.numpy(), _np(jk))
    assert jr.uniform(tk).numpy() == np.asarray(jax.random.uniform(jk))
    with pytest.raises(ValueError):
        key_from_numpy(np.zeros(3, np.uint32))


@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 + 5])
@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (64, 33)])
def test_random_bits_and_shaped_uniform(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    bits = jr.random_bits(tk, shape)
    assert bits.shape == shape
    assert np.array_equal(bits.numpy(), np.asarray(
        jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    u = jr.uniform(tk, shape)
    assert u.dtype == torch.float32
    assert np.array_equal(u.numpy(), np.asarray(jax.random.uniform(jk, shape)))


@pytest.mark.parametrize("span", [1, 60, 400, 65_536, 65_537, 131_071,
                                  2 ** 17])
@pytest.mark.parametrize("seed", [0, 7])
def test_randint(span, seed):
    """Spans that are not powers of two are where the uint32 wraparound
    of the multiplier and the products matters."""
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    tk = jr.fold_in(jr.PRNGKey(seed), 5)
    for lo, shape in ((0, (256, 5)), (3, (9,)), (-40, (2, 3, 4))):
        want = np.asarray(jax.random.randint(jk, shape, lo, lo + span))
        got = jr.randint(tk, shape, lo, lo + span)
        assert got.dtype == torch.int32 and got.shape == shape
        assert np.array_equal(got.numpy(), want)
    # maxval <= minval gives minval, as in JAX
    assert np.array_equal(jr.randint(tk, (4,), 5, 5).numpy(),
                          np.asarray(jax.random.randint(jk, (4,), 5, 5)))


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 70_000])
def test_permutation(n):
    """70,000 elements take 2 stable sort rounds (ceil(3 ln n / ln(2^32
    - 1))); fewer than ~1,600 take 1, and 0 or 1 element take none."""
    for seed in (0, 3):
        jk = jax.random.PRNGKey(seed)
        got = jr.permutation(jr.PRNGKey(seed), n)
        assert np.array_equal(got.numpy(),
                              np.asarray(jax.random.permutation(jk, n)))
    assert np.array_equal(np.sort(got.numpy()), np.arange(n))


@pytest.mark.parametrize("chunk", [7, 64, 1000])
@pytest.mark.parametrize("shape", [(7,), (9, 13), (2, 64, 8), (1000,)])
def test_chunked_draws_equal_one_chunk_and_jax(monkeypatch, chunk, shape):
    """Shaped draws evaluated in chunks of ``chunk`` flat indices (a small
    test-only chunk, so sizes straddle chunk edges): ``random_bits``,
    ``uniform``, ``normal`` and ``randint`` are ``torch.equal`` to one
    chunk, and the integer and uniform draws equal ``jax.random``."""
    jk, tk = jax.random.PRNGKey(5), jr.PRNGKey(5)

    def draws():
        return (jr.random_bits(tk, shape), jr.uniform(tk, shape, -2.0, 3.5),
                jr.normal(tk, shape), jr.randint(tk, shape, -3, 70_001))
    whole = draws()
    monkeypatch.setattr(jr, "CHUNK", chunk)
    for a, b in zip(draws(), whole):
        assert a.dtype == b.dtype and torch.equal(a, b)
    bits, uni, _, ints = draws()
    assert np.array_equal(bits.numpy(), np.asarray(
        jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    assert np.array_equal(uni.numpy(), np.asarray(
        jax.random.uniform(jk, shape, minval=-2.0, maxval=3.5)))
    assert np.array_equal(ints.numpy(), np.asarray(
        jax.random.randint(jk, shape, -3, 70_001)))


def test_meta_draws_return_their_shape_without_computing():
    """On ``meta`` a draw is an empty tensor of its shape and dtype: no
    threefry rounds run (one evaluation is ~140 ops), whatever the size;
    ``randint``'s key split adds a few ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))
    key = jr.PRNGKey(0, device="meta")
    shape = (16, 4096, 14336)
    for draw, dtype in ((lambda: jr.normal(key, shape), torch.float32),
                        (lambda: jr.uniform(key, shape), torch.float32),
                        (lambda: jr.random_bits(key, shape), torch.int64),
                        (lambda: jr.randint(key, shape, 0, 9), torch.int32)):
        with Ops() as seen:
            out = draw()
        assert out.is_meta and out.shape == shape and out.dtype == dtype
        assert len(seen.ops) < 12, seen.ops
    with Ops() as seen:
        sub = jr.split(jr.fold_in(key, 3), 4)
    assert sub.shape == (4, 2) and sub.is_meta and len(seen.ops) < 20


# --------------------------------------------------- the threefry kernel --

def _key(gen, *shape):
    """Random [*shape, 2] keys of uint32 words."""
    return torch.randint(0, 2 ** 32, shape + (2,), generator=gen,
                         dtype=torch.int64)


def _cases(dev):
    """(name, key, x0, x1, shape, out) evaluations of the main paths'
    forms on ``dev``: a fold_in over walkers and over the [W, 79] grid of
    step_uniforms (keys [W, 1] against data [1, 79], no copy), split,
    uniform on split's non-contiguous halves, shaped draws' counters with
    a non-zero high word, and shapes the kernel merges or does not."""
    gen = torch.Generator().manual_seed(0)
    sub = jr.split(_key(gen, 40))
    data5 = torch.randint(-2 ** 40, 2 ** 40, (3, 5, 1, 5), generator=gen)
    cases = [
        ("fold_in_int", _key(gen, 64), 0, 12345, (64,), "key"),
        ("fold_in_int32", _key(gen, 64), 0,
         torch.arange(64, dtype=torch.int32) * 1000003 - 5, (64,), "key"),
        ("fold_in_one_key_int32", _key(gen), 0,
         torch.arange(64, dtype=torch.int32) * 1000003 - 5, (64,), "key"),
        ("grid", _key(gen, 33)[:, None], 0,
         torch.arange(1, 80)[None, :], (33, 79), "key"),
        ("split", _key(gen, 17, 3).unsqueeze(-2), 0, TF.Count(0, 2),
         (17, 3, 4), "key"),
        ("uniform_view0", sub[:, 0], 0, 0, (40,), "uniform"),
        ("uniform_view1", sub[:, 1], 0, 0, (40,), "uniform"),
        ("five_dims", _key(gen, 2, 3, 1, 4, 5), 7, data5, (2, 3, 5, 4, 5),
         "key"),
        ("transposed", _key(gen, 6, 7).transpose(0, 1), 0, 3, (7, 6), "xor"),
        ("scalar", _key(gen), 1, 2, (), "key"),
    ]
    k = _key(gen)
    for lo in (0, 2 ** 32 - 3, 2 ** 33 + 7):
        for out in ("xor", "uniform"):
            cases.append((f"count_{lo}_{out}", k, TF.Count(lo, 0, hi=True),
                          TF.Count(lo, 0), (1000,), out))
    return [(name, key.to(dev), *(x.to(dev) if isinstance(x, torch.Tensor)
                                   else x for x in (x0, x1)), shape, out)
            for name, key, x0, x1, shape, out in cases]


CASE_NAMES = [c[0] for c in _cases("cpu")]


def _emulate(desc, ptrs, operands, out):
    """What the kernel computes from ``describe``'s descriptor, on the
    CPU: each operand read by the descriptor's sizes and strides (a tensor
    through ``as_strided`` at its own storage offset, so the pointer and
    the strides are what is checked) or computed from the coordinates,
    then the plain threefry and the epilogue."""
    ndim = desc[0]
    sizes = desc[2:2 + ndim]
    coords = torch.meshgrid([torch.arange(s) for s in sizes], indexing="ij")
    words, at = [], 2 + ndim
    for x, ptr in zip(operands, ptrs):
        kind, base, strides = desc[at], desc[at + 1], \
            desc[at + 2:at + 2 + ndim]
        at += 2 + ndim
        if ptr is not None:
            assert ptr == x.data_ptr() and kind == (
                0 if x.dtype == torch.int64 else 1)
            v = torch.as_strided(x, sizes, strides, x.storage_offset())
            v = v.long() & jr.MASK
        else:
            v = base + sum(c * st for c, st in zip(coords, strides))
            v = v >> 32 if kind == 3 else v & jr.MASK
        words.append(v.reshape(-1))
    o0, o1 = jr.threefry2x32_plain(*words)
    if out == "key":
        return torch.stack([o0, o1], dim=-1)
    return jr._to_float(o0 ^ o1) if out == "uniform" else o0 ^ o1


@pytest.mark.parametrize("case", CASE_NAMES)
def test_kernel_descriptor_emulated_equals_plain(case):
    """The wrapper's descriptor (broadcast strides, merged dims, computed
    counters) read as the kernel reads it gives the plain version's bits:
    the kernel's indexing held on the CPU."""
    name, key, x0, x1, shape, out = next(c for c in _cases("cpu")
                                         if c[0] == case)
    operands = (key[..., 0], key[..., 1], x0, x1)
    desc, ptrs = TF.describe(shape, operands, key.device)
    assert desc[1] == int(np.prod(shape))
    got = _emulate(desc, ptrs, operands, out)
    want = jr._evaluate(key, x0, x1, shape, out)
    assert torch.equal(got.reshape(want.shape), want)
    if case == "grid":      # [33, 1] keys and [1, 79] data: two dims read
        assert desc[0] == 2 and desc[2:4] == [33, 79]


def test_kernel_refuses_other_devices_and_dtypes():
    key = jr.PRNGKey(1)
    with pytest.raises(ValueError, match="runs on cuda"):
        TF.threefry2x32(key[0], key[1], 0, 1, (), "key")
    with pytest.raises(ValueError, match="out must be"):
        TF.threefry2x32(key[0], key[1], 0, 1, (), "pair")
    meta = torch.device("meta")
    with pytest.raises(TypeError, match="k0 must be"):
        TF.describe((4,), (key.float(), key[1], 0, 1), key.device)
    with pytest.raises(TypeError, match="x1 must be"):
        TF.describe((4,), (key[0], key[1], 0, torch.zeros(4)), key.device)
    with pytest.raises(TypeError, match="x0 must be"):
        TF.describe((4,), (key[0], key[1], 0.5, 1), key.device)
    with pytest.raises(ValueError, match="is on cpu"):
        TF.describe((4,), (key[0], key[1], 0, torch.zeros(4).long()), meta)
    with pytest.raises(ValueError, match="does not broadcast"):
        TF.describe((4,), (key[0], key[1], 0, torch.zeros(3).long()),
                    key.device)
    with pytest.raises(ValueError, match="counts along dim"):
        TF.describe((4,), (key[0], key[1], 0, TF.Count(0, 1)), key.device)
    with pytest.raises(ValueError, match="at most"):
        TF.describe((1,) * 9, (key[0], key[1], 0, 1), key.device)


def _no_kernel(monkeypatch):
    """Make any build or launch of the kernel fail the test."""
    def refuse():
        raise AssertionError("the threefry kernel was loaded")
    monkeypatch.setattr(TF, "_lib", refuse)
    return TF.threefry2x32.launches


def test_cpu_keys_take_the_plain_version_without_a_launch(monkeypatch):
    before = _no_kernel(monkeypatch)
    key = jr.PRNGKey(7)
    keys = jr.fold_in(key, torch.arange(5))
    o0, o1 = jr.threefry2x32_plain(key[0], key[1], torch.zeros(5).long(),
                                   torch.arange(5))
    assert torch.equal(keys, torch.stack([o0, o1], dim=-1))
    assert torch.equal(jr._evaluate(key, 0, torch.arange(5), (5,), "xor"),
                       o0 ^ o1)
    ids = torch.tensor([0, 5, 2 ** 31 - 1, -7], dtype=torch.int32)
    assert torch.equal(jr.fold_in(key, ids), jr.fold_in(key, ids.long()))
    jr.split(keys, 3), jr.uniform(keys), jr.random_bits(key, (9,))
    jr.randint(key, (9,), 0, 7), jr.normal(key, (9,))
    assert TF.threefry2x32.launches == before


def test_meta_keys_return_their_shape_without_a_launch(monkeypatch):
    before = _no_kernel(monkeypatch)
    key = jr.PRNGKey(0, device="meta")
    keys = jr.fold_in(key, torch.arange(6, device="meta"))
    assert keys.is_meta and keys.shape == (6, 2)
    assert jr.split(keys, 3).shape == (6, 3, 2)
    u = jr.uniform(keys)
    assert u.is_meta and u.shape == (6,) and u.dtype == torch.float32
    bits = jr._evaluate(keys, 0, 1, (6,), "xor")
    assert bits.is_meta and bits.shape == (6,) and bits.dtype == torch.int64
    assert jr.random_bits(key, (4, 5)).shape == (4, 5)
    assert TF.threefry2x32.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASE_NAMES)
def test_kernel_equals_plain_on_card(cuda, case):
    """One launch an evaluation, torch.equal to the plain version on the
    CPU: broadcast operands read in place, non-contiguous views, counters
    past 2^32, every epilogue."""
    name, key, x0, x1, shape, out = next(c for c in _cases(cuda)
                                         if c[0] == case)
    cpu = [x.cpu() if isinstance(x, torch.Tensor) else x
           for x in (key, x0, x1)]
    before = TF.threefry2x32.launches
    got = jr._evaluate(key, x0, x1, shape, out)
    assert TF.threefry2x32.launches == before + 1
    assert got.is_cuda and torch.equal(got.cpu(),
                                       jr._evaluate(*cpu, shape, out))


@pytest.mark.cuda
def test_public_draws_on_card_equal_cpu(cuda, monkeypatch):
    """Every public draw on the card equals the CPU's, shaped draws across
    CHUNK boundaries too (a small chunk: several launches a draw).
    ``normal``'s ``erf_inv`` inputs (the chunks' uniforms, scaled) are
    bit-equal too; its values are within ``erf_inv``'s 3 ulps of the CPU's
    (the card's ``log1p`` rounds otherwise on some inputs) and equal to the
    card's own one-chunk draw."""
    def draws(dev):
        key = jr.PRNGKey(2 ** 31 + 5, device=dev)
        keys = jr.fold_in(key, torch.arange(300, device=dev))
        return (keys, jr.split(keys, 3), jr.uniform(keys, minval=-1.0,
                                                    maxval=2.0),
                jr.random_bits(key, (7, 129)), jr.uniform(key, (1000,)),
                jr.uniform(key, (3, 333), -2.0, 3.5),
                jr.randint(key, (999,), -3, 70_001),
                jr.permutation(key, 5000))
    def normal_parts(dev):
        key = jr.PRNGKey(9, device=dev)
        inputs = jr._draw(key, (4, 4099), torch.float32, lambda floats:
                          jr._scale(floats, jr._NORMAL_LO, 1.0),
                          out="uniform")
        return inputs, jr.normal(key, (4, 4099))
    whole = normal_parts(cuda)[1]
    for chunk in (jr.CHUNK, 257):
        monkeypatch.setattr(jr, "CHUNK", chunk)
        for a, b in zip(draws(cuda), draws("cpu")):
            assert a.is_cuda and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b)
        (inputs, normal), (inputs_cpu, normal_cpu) = map(normal_parts,
                                                         (cuda, "cpu"))
        assert torch.equal(inputs.cpu(), inputs_cpu)
        ulps = (normal.cpu().view(torch.int32).long()
                - normal_cpu.view(torch.int32).long()).abs()
        assert int(ulps.max()) <= 3
        assert torch.equal(normal, whole)


@pytest.mark.cuda
def test_fused_exact_superstep_adds_three_launches(cuda):
    """A fused exact superstep draws fold_in, split and uniform: three
    launches. A walk of length L: the walkers' keys (1), step 0's alias
    draw (4: fold_in, split, two uniforms), then 3 a superstep."""
    from repro_torch.core.graph import PaddedGraph
    from repro_torch.core.walk import run_reference
    from repro_torch.data.store import open_graph
    from repro_torch.engine.sampler import Sampler
    pg = PaddedGraph.build(open_graph("wec:k=8,deg=12,seed=1").graph,
                           device=cuda)
    starts = torch.arange(pg.n, dtype=torch.int32, device=cuda)

    def launches(length):
        before = TF.threefry2x32.launches
        run_reference(pg, starts, starts, jr.PRNGKey(5, device=cuda),
                      Sampler(p=0.5, q=2.0, fused=True), length)
        return TF.threefry2x32.launches - before
    assert launches(5) == 5 + 3 * 4
    assert launches(6) - launches(5) == 3


@pytest.mark.cuda
def test_kernel_refuses_wrong_dtype_or_device_on_card(cuda):
    key = jr.PRNGKey(3, device=cuda)
    with pytest.raises(TypeError, match="k0 must be"):
        TF.threefry2x32(key[0].float(), key[1], 0, 1, (), "key")
    with pytest.raises(TypeError, match="x1 must be"):
        TF.threefry2x32(key[0], key[1], 0, torch.ones(3, device=cuda), (3,),
                        "key")
    with pytest.raises(ValueError, match="is on cpu"):
        TF.threefry2x32(key[0], key[1], 0, torch.ones(3).long(), (3,), "key")

"""The trainer twin (exllamav2_tpu_torch/cli/train_fixture.py) against the
reference's tools/train_fixture.py on the CPU, at the reference's shapes
(2 layers, hidden 256, 8/4 heads, vocab 384, batch 8 x 256 tokens, seed 7).

* Step 0: the loss within LOSS_TOL of the reference's jax.value_and_grad
  loss on the same batch and init, every gradient within GRAD_TOL of its max
  |grad|. The reference runs jitted with XLA's excess precision off (as
  tests/test_torch_archs.py does). Both packages take f32 products on the
  CPU and round to bf16 at the same points, but their f32 sums run in
  another order, so a bf16 activation lands one ulp apart now and then
  (layer 0's q: 7 of 524,288 values at seed 7, measured) and the rows
  attending through it move; the gradients then part by up to 7.7e-4 of
  their max (layer 0's k), the loss by 6.7e-6 (measured). A missing or extra
  rounding point moves every value by up to 2^-9 of itself.
* AdamW: three port steps against optax.adamw(cosine_decay_schedule(...))
  on the same seeded gradients, within 1e-6 of max |w|, the RoPE tables
  decayed to the reference's ratio.
* train(steps=3) against the reference's: the last loss within LOSS3_TOL;
  the RoPE tables within 1e-6 (ratio 0.999937 of fresh); every other tensor
  within ADAM_TOL where Adam's g / sqrt(v) is far from zero. Adam moves a
  weight by about lr a step whatever |g| is, so where a gradient is near
  zero the two packages' gradient noise (above) flips the update's sign:
  at most STEP_FLIP_FRACTION of a tensor's values part by up to 2 lr a
  step (measured 0.49 % at most, layer 0's q, up to 6.2e-3).
* export: the reference's 3-step weights through the port's export give the
  reference's file bit for bit (same names, shapes, dtypes and fp16 values);
  the config differs in the `_trained_fixture` names only; the port's own
  3-step export has the same layout and its values within one fp16 ulp
  plus ADAM_TOL but where Adam flipped (as the weights above).
* The dense product's autograd.Function (ops/qmm.BF16Dot): its backward
  against autograd of the plain f32 product; dot_f32 takes the product
  itself (no Function) under inference_mode, no_grad, or on buffers.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from exllamav2_tpu_torch.cli import train_fixture as P
from exllamav2_tpu_torch.ops import qmm as Q
from exllamav2_tpu_torch.stloader import STFile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
GRAD_TOL = 2e-3
ADAM_TOL = 1e-4
# the third step's loss, after two updates that part as described above
# (measured 2.9e-4 of 4.16)
LOSS3_TOL = 1e-3
STEP_FLIP_FRACTION = 0.01
ROPE_RATIO_3 = 0.999937       # sin / cos after 3 steps of decay (reference)


@pytest.fixture(scope="module")
def ref():
    """The reference's tools/train_fixture.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "ref_train_fixture", os.path.join(REPO, "tools", "train_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _name(path) -> str:
    """A reference pytree key path -> the port's buffer name."""
    import jax
    return re.sub(r"\[(\d+)\]", r".\1", jax.tree_util.keystr(path)).lstrip(
        ".")


def _leaves(tree) -> dict:
    import jax
    return {_name(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _exact_jit(fn, *args):
    import jax
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _ref_init(ref):
    """The reference trainer's initial f32 params and static model."""
    import tempfile

    import jax
    import jax.numpy as jnp
    from exllamav2_tpu.models.model import Model
    from exllamav2_tpu.utils.testing import make_tiny_llama
    d = os.path.join(tempfile.mkdtemp(prefix="ref_train_"), "init")
    make_tiny_llama(d, quant=None, vocab=ref.VOCAB, hidden=ref.HIDDEN,
                    layers=ref.LAYERS, heads=ref.HEADS,
                    kv_heads=ref.KV_HEADS, inter=ref.INTER, max_pos=2048,
                    seed=7, scale=0.03)
    m = Model.from_dir(d, prescale=False)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, m.weights)
    return params, m.static


def test_batches_and_schedule_match_reference(ref):
    import optax
    assert np.array_equal(P.corpus_tokens(), ref.corpus_tokens())
    a = P.batches(P.corpus_tokens(), np.random.default_rng(7), 8)
    b = ref.batches(ref.corpus_tokens(), np.random.default_rng(7), 8)
    for _ in range(3):
        assert np.array_equal(next(a), next(b))
    sched = optax.cosine_decay_schedule(3e-3, 1200, 0.1)
    for count in (0, 1, 2, 599, 1199, 1200, 1500):
        assert P.cosine_lr(3e-3, 1200, count) == pytest.approx(
            float(sched(count)), rel=1e-6)


def test_step0_loss_and_gradients_match_reference(ref):
    import jax
    import jax.numpy as jnp
    from exllamav2_tpu.cache import KVCache
    from exllamav2_tpu.models.forward import model_forward
    params, st = _ref_init(ref)
    ids = next(ref.batches(ref.corpus_tokens(), np.random.default_rng(7), 8))

    def loss_fn(w, ids):                   # the reference's train.loss_fn
        cache = KVCache.alloc(st.num_layers, ids.shape[0], ref.SEQ,
                              st.num_kv_heads, st.head_dim)
        logits, _ = model_forward(w, st, ids[:, :-1], cache, jnp.int32(0),
                                  attn_limit=ref.SEQ)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return jnp.mean(-jnp.take_along_axis(logp, ids[:, 1:][..., None],
                                             axis=-1))

    loss, grads = _exact_jit(jax.value_and_grad(loss_fn), params,
                             jnp.asarray(ids))
    want = _leaves(grads)

    template, pst, pp = P.init_model(7, "cpu")
    init = _leaves(params)
    assert set(pp) == set(init)
    for n, t in pp.items():             # the same initial weights
        assert np.array_equal(t.detach().numpy(), init[n]), n
    got = P.loss_fn(P.to_weights(template, pp), pst, torch.as_tensor(ids))
    got.backward()
    assert abs(got.item() - float(loss)) <= LOSS_TOL
    trained = [n for n in pp if n not in P.ROPE]
    assert len(trained) == 21
    for n in trained:
        g, w = pp[n].grad.numpy(), want[n]
        scale = np.abs(w).max()
        assert scale > 0, n
        assert np.abs(g - w).max() <= GRAD_TOL * scale, (
            n, np.abs(g - w).max() / scale)
    for n in P.ROPE:                   # constants: no gradient is taken
        assert pp[n].grad is None and not pp[n].requires_grad


def test_adamw_matches_optax_on_the_same_gradients():
    import jax.numpy as jnp
    import optax
    steps, lr = 3, 3e-3            # the schedule of train(steps=3)
    _, _, pp = P.init_model(7, "cpu")
    names = list(pp)
    w0 = {n: pp[n].detach().numpy().copy() for n in names}
    rng = np.random.default_rng(3)
    grads = [{n: (rng.standard_normal(w0[n].shape) * 1e-2).astype(
        np.float32) for n in names} for _ in range(3)]
    for g in grads:
        for n in P.ROPE:
            g[n][:] = 0.0

    opt = optax.adamw(optax.cosine_decay_schedule(lr, steps, 0.1),
                      weight_decay=0.01)
    jw = {n: jnp.asarray(w0[n]) for n in names}
    state = opt.init(jw)
    for g in grads:
        upd, state = opt.update({n: jnp.asarray(g[n]) for n in names},
                                state, jw)
        jw = optax.apply_updates(jw, upd)

    popt = P.optimizer(pp, lr)
    for i, g in enumerate(grads):
        for n in names:
            if n not in P.ROPE:
                pp[n].grad = torch.as_tensor(g[n])
        P.update(popt, pp, lr, steps, i)
    for n in names:
        got, want = pp[n].detach().numpy(), np.asarray(jw[n])
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), n
    for n in P.ROPE:
        big = np.abs(w0[n]) > 0.1
        ratio = (pp[n].detach().numpy()[big] / w0[n][big]).mean()
        assert abs(ratio - ROPE_RATIO_3) < 1e-6, ratio


def test_three_steps_match_reference_train(ref, tmp_path):
    want_w, want_loss = ref.train(steps=3, log=lambda *a: None)
    got_w, got_loss = P.train(steps=3, device="cpu", log=lambda *a: None)
    assert abs(got_loss - want_loss) <= LOSS3_TOL
    want = _leaves(want_w)
    got = {n: b.numpy() for n, b in got_w.named_buffers()}
    assert set(got) == set(want)
    _, _, fresh = P.init_model(7, "cpu")
    for n in P.ROPE:
        assert np.abs(got[n] - want[n]).max() <= 1e-6
        big = np.abs(fresh[n].detach().numpy()) > 0.1
        ratio = (got[n][big] / fresh[n].detach().numpy()[big]).mean()
        assert abs(ratio - ROPE_RATIO_3) < 1e-6, ratio
    for n in got:
        d = np.abs(got[n] - want[n])
        assert (d > ADAM_TOL).mean() <= STEP_FLIP_FRACTION, n
        assert d.max() <= 3 * 2 * 3e-3, n

    # the port's export of the reference's weights is the reference's file
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref.export(want_w, str(ref_dir), want_loss)
    template, _, _ = P.init_model(7, "cpu")
    as_port = P.to_weights(template, {n: torch.from_numpy(v.copy())
                                      for n, v in want.items()})
    P.export(as_port, str(port_dir), want_loss)
    a = STFile(str(ref_dir / "model.safetensors"))
    b = STFile(str(port_dir / "model.safetensors"))
    assert sorted(a.keys()) == sorted(b.keys())
    assert len(a.keys()) == 21
    for k in a.keys():
        x, y = a.get_tensor(k), b.get_tensor(k)
        assert x.dtype == y.dtype == np.float16 and x.shape == y.shape, k
        assert np.array_equal(x.view(np.uint16), y.view(np.uint16)), k
    ca = json.load(open(ref_dir / "config.json"))
    cb = json.load(open(port_dir / "config.json"))
    ta, tb = ca.pop("_trained_fixture"), cb.pop("_trained_fixture")
    assert ca == cb and ta["final_loss"] == tb["final_loss"]
    assert tb["trainer"] == "exllamav2_tpu_torch/cli/train_fixture.py"
    assert tb["corpus"] == "exllamav2_tpu_torch/convert/standard_cal.py"

    # and the port's own 3-step export: one fp16 ulp beyond the weights'
    # ADAM_TOL where Adam agreed
    P.export(got_w, str(tmp_path / "own"), got_loss)
    c = STFile(str(tmp_path / "own" / "model.safetensors"))
    assert sorted(c.keys()) == sorted(a.keys())
    for k in a.keys():
        x, y = a.get_tensor(k), c.get_tensor(k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        ulp = np.abs(np.spacing(x.astype(np.float16)).astype(np.float32))
        far = np.abs(x.astype(np.float32) - y.astype(np.float32)) > \
            ulp + ADAM_TOL
        assert far.mean() <= STEP_FLIP_FRACTION, k
    for f in (a, b, c):
        f.close()


def test_bf16_dot_backward_matches_plain_autograd():
    """BF16Dot on bf16 operands (2-D and batched) against autograd of the
    f32 product of the same values: the forward exact (bf16 products are
    exact in f32), each cotangent within the bf16 roundings of the
    cotangent and of the result, 2^-7 of its max; also where an operand
    is a view that is written in place before the backward."""
    rng = np.random.default_rng(11)
    for shape_a, shape_b in (((24, 40), (40, 16)), ((3, 12, 32), (3, 32, 8))):
        a = torch.as_tensor(rng.standard_normal(shape_a), dtype=torch.float32
                            ).to(torch.bfloat16).requires_grad_()
        b = torch.as_tensor(rng.standard_normal(shape_b), dtype=torch.float32
                            ).to(torch.bfloat16).requires_grad_()
        g = torch.as_tensor(rng.standard_normal(shape_a[:-1] + shape_b[-1:]),
                            dtype=torch.float32)
        y = Q.BF16Dot.apply(a, b)
        assert y.dtype == torch.float32
        y.backward(g)
        af = a.detach().float().requires_grad_()
        bf = b.detach().float().requires_grad_()
        yp = torch.matmul(af, bf)
        yp.backward(g)
        assert torch.equal(y.detach(), yp.detach())
        for got, want in ((a.grad, af.grad), (b.grad, bf.grad)):
            assert got.dtype == torch.bfloat16
            err = (got.float() - want).abs().max() / want.abs().max()
            assert err <= 2 ** -7, err.item()
    # an operand that is a view written in place after the forward (the
    # cache rows the next layer's update writes): the backward takes the
    # forward's values
    cache = torch.as_tensor(rng.standard_normal((2, 40, 16)),
                            dtype=torch.float32).to(torch.bfloat16)
    a = torch.as_tensor(rng.standard_normal((24, 40)), dtype=torch.float32
                        ).to(torch.bfloat16).requires_grad_()
    want = cache[0].float().t().clone()
    y = Q.BF16Dot.apply(a, cache[0])
    cache[0].zero_()
    y.backward(torch.ones_like(y))
    plain = torch.ones(24, 16) @ want
    err = (a.grad.float() - plain).abs().max() / plain.abs().max()
    assert err <= 2 ** -7, err.item()


def test_dot_takes_the_product_itself_without_grad(monkeypatch):
    """dot_f32 (what _dot and the t > 1 attention products call on the
    card) goes through BF16Dot only while autograd records and an operand
    requires grad: the serving path is the product itself."""
    calls = []
    real = Q.BF16Dot.apply

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(Q.BF16Dot, "apply", counted)
    a = torch.randn(8, 16).to(torch.bfloat16)
    w = torch.nn.Buffer(torch.randn(16, 4).to(torch.bfloat16))
    plain = torch.matmul(a.float(), w.float())
    leaf = w.detach().clone().requires_grad_()
    with torch.inference_mode():
        y = Q.dot_f32(a, leaf)
    with torch.no_grad():
        y2 = Q.dot_f32(a, leaf)
    y3 = Q.dot_f32(a, w)
    assert not calls
    for t in (y, y2, y3):
        assert t.grad_fn is None and torch.equal(t, plain)
    y4 = Q.dot_f32(a, leaf)
    assert calls and torch.equal(y4.detach(), plain)
    assert type(y4.grad_fn).__name__ == "BF16DotBackward"


@pytest.mark.cuda
def test_dot_on_the_card_keeps_the_serving_product():
    """On the card: _dot without grad is torch.mm(out_dtype=f32) bitwise;
    with a leaf that requires grad it is the same value through BF16Dot,
    and its backward reaches the leaf in bf16 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.mm with out_dtype has no "
                    "CPU kernel)")
    g = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn(64, 256, device="cuda", generator=g)
    w = torch.randn(256, 128, device="cuda", generator=g)
    want = torch.mm(a.to(torch.bfloat16), w.to(torch.bfloat16),
                    out_dtype=torch.float32)
    with torch.inference_mode():
        assert torch.equal(Q._dot(a, w), want)
    leaf = w.clone().requires_grad_()
    y = Q._dot(a, leaf)
    assert type(y.grad_fn).__name__ != "MmBackward0"
    assert torch.equal(y.detach(), want)
    y.sum().backward()
    plain = a.to(torch.bfloat16).float().t() @ torch.ones_like(want)
    err = (leaf.grad - plain).abs().max() / plain.abs().max()
    assert err <= 2 ** -7

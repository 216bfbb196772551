"""The port's encoder rewrites against the JAX package on the CPU
(``ode_vio_tpu_torch/models/encoders.py``, ``models/fold.py``): the
value-level BatchNorm fold, the space-to-depth conv (``encoder_s2d``) and
the eval-time int8 conv (``encoder_int8``), at tiny widths in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu.models import encoders as jax_encoders
from ode_vio_tpu.models.fold import fold_batchnorm as jax_fold_batchnorm
from ode_vio_tpu_torch.models import encoders
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.models.fold import fold_batchnorm
from ode_vio_tpu_torch.training.loop import make_infer_fn

from torch_port_helpers import batch, configs, jax_model, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNGS = {"gumbel": jax.random.PRNGKey(0)}


@pytest.fixture(scope="module")
def tiny():
    """The tiny configuration's JAX model (non-trivial BatchNorm statistics)
    and its variables bridged into the port's state_dict layout."""
    jc, tc = configs()
    jm, variables = jax_model(jc)
    return jc, tc, variables, from_jax_variables(variables, tc.model)


def port_model(tc, sd, **model_fields):
    import dataclasses

    model = DeepVIO(dataclasses.replace(tc.model, **model_fields), tc.solver,
                    tc.cde_solver_cfg)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


# --- the value-level fold --------------------------------------------------

def test_fold_batchnorm_matches_jax(tiny):
    """The port's fold of the bridged weights equals the bridge of JAX's
    fold, bit for bit, in every image-trunk and IMU-encoder tensor: conv
    kernels times s, BatchNorms as identity plus shift, the IMU convs'
    biases zeroed."""
    _, tc, variables, sd = tiny
    want = from_jax_variables(jax_fold_batchnorm(variables), tc.model)
    got = fold_batchnorm(sd)
    assert got.keys() == sd.keys() == want.keys()
    enc = [k for k in got if k.startswith(("Image_net.", "Inertial_net."))]
    assert len(enc) > 60
    for k in enc:
        assert torch.equal(got[k], want[k]), k
    for k in ("Inertial_net.encoder_conv.0.bias", "Image_net.conv3.1.running_mean"):
        assert not got[k].any()
    assert sd["Image_net.conv3.1.running_mean"].any()
    assert torch.equal(got["Image_net.conv1.1.weight"], torch.ones(64))


def test_value_fold_keeps_the_eval_output(tiny):
    """A model of folded values gives the unfolded model's features in
    float32 to rounding (the fold is exact in real arithmetic)."""
    _, tc, _, sd = tiny
    img, imu, _ = batch([3, 4])
    img, imu = torch.from_numpy(img), torch.from_numpy(imu)
    with torch.no_grad():
        plain = port_model(tc, sd).encode(img, imu)
        folded = port_model(tc, fold_batchnorm(sd)).encode(img, imu)
    for a, b in zip(plain, folded):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


# --- space-to-depth ------------------------------------------------------------

@pytest.mark.parametrize("k,cin,cout", [(7, 6, 8), (5, 4, 8), (3, 6, 8)])
def test_s2d_conv_matches_jax(k, cin, cout):
    """The bound of tests/test_encoder_s2d.py: atol 1e-4."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 16, 24, cin)).astype(np.float32)
    kernel = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    want = jax_encoders._space_to_depth_conv(jnp.asarray(x), jnp.asarray(kernel), jnp.float32)
    got = encoders.s2d_conv(nchw(x), torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    assert got.shape == (2, cout, 8, 12)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-4)


def test_s2d_applies_to_conv1_and_conv2_only(tiny):
    _, tc, _, sd = tiny
    net = port_model(tc, sd, encoder_s2d=True).Image_net
    assert [name for name in encoders.TRUNK_NAMES if getattr(net, name).s2d] == ["conv1",
                                                                                "conv2"]


def test_s2d_encoder_outputs_match_direct(tiny):
    """With and without s2d, eval features within 2e-4 (the JAX package's
    bound for the same check)."""
    _, tc, _, sd = tiny
    img, imu, _ = batch([5])
    img = torch.from_numpy(img)
    with torch.no_grad():
        direct = port_model(tc, sd).Image_net(img)
        s2d = port_model(tc, sd, encoder_s2d=True).Image_net(img)
    torch.testing.assert_close(s2d, direct, rtol=0, atol=2e-4)


def test_s2d_train_gradient_matches_direct(tiny):
    """s2d runs in training too: the gradient of ``conv1.0.weight`` through
    the rewrite (train-mode BatchNorm, dropout 0 so both paths draw
    nothing) within 1e-4 of its largest entry of the direct conv's."""
    _, tc, _, sd = tiny
    img, _, _ = batch([6, 7])
    img = torch.from_numpy(img)
    trunk = tuple((f, k, s, 0.0) for f, k, s, _ in encoders.TRUNK)
    grads = []
    for s2d in (False, True):
        import dataclasses

        net = encoders.ImageEncoder(dataclasses.replace(tc.model, encoder_s2d=s2d), trunk)
        net.load_state_dict({k[len("Image_net."):]: v for k, v in sd.items()
                             if k.startswith("Image_net.")})
        out = net.train()(img)
        weight = torch.from_numpy(np.random.default_rng(8).standard_normal(out.shape)
                                  .astype(np.float32))
        (g,) = torch.autograd.grad((out * weight).sum(), net.conv1[0].weight)
        grads.append(g)
    assert net.conv1.s2d and net.conv2.s2d
    scale = grads[0].abs().max()
    assert scale > 0
    assert (grads[1] - grads[0]).abs().max() <= 1e-4 * scale


# --- int8 ------------------------------------------------------------------------

def jax_int8_internals(x, kernel, stride, pad, monkeypatch):
    """JAX ``_int8_conv`` of NHWC ``x`` and HWIO ``kernel``: its int8
    activations and weights and its int32 accumulators (captured at its
    ``lax.conv_general_dilated`` call), and its output."""
    seen = {}
    conv = jax.lax.conv_general_dilated

    def capture(lhs, rhs, *args, **kw):
        out = conv(lhs, rhs, *args, **kw)
        seen.update(xq=np.asarray(lhs), kq=np.asarray(rhs), acc=np.asarray(out))
        return out

    monkeypatch.setattr(jax.lax, "conv_general_dilated", capture)
    y = jax_encoders._int8_conv(jnp.asarray(x), jnp.asarray(kernel), stride, pad, jnp.float32)
    monkeypatch.undo()
    return seen, np.asarray(y)


@pytest.mark.parametrize("k,stride,cin,cout", [(7, 2, 6, 64), (5, 2, 64, 128), (3, 1, 16, 8)])
def test_int8_conv_matches_jax(k, stride, cin, cout, monkeypatch):
    """From the same float input: the int8 activations and weights and the
    int32 accumulators equal JAX's exactly (plain version and
    ``int8_accumulate`` on the CPU), the outputs within 1e-6 relative."""
    rng = np.random.default_rng(k + cin)
    x = rng.standard_normal((3, 16, 24, cin)).astype(np.float32)
    x[1] *= 40.0  # lanes of other magnitudes: per-lane scales
    kernel = (0.1 * rng.standard_normal((k, k, cin, cout))).astype(np.float32)
    pad = (k - 1) // 2
    seen, want = jax_int8_internals(x, kernel, stride, pad, monkeypatch)

    xt, wt = nchw(x), torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    kq, kscale = encoders.quantize_weight(wt)
    xq, ascale = encoders.quantize_activation(xt)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), seen["xq"])
    np.testing.assert_array_equal(kq.permute(2, 3, 1, 0).numpy(), seen["kq"])
    for accumulate in (encoders.int8_accumulate_plain, encoders.int8_accumulate):
        acc = accumulate(xq, kq, stride, pad)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), seen["acc"])
    got = encoders.int8_conv(xt, wt, stride, pad, use_kernels=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape,k,stride", [((2, 6, 16, 24), 7, 2), ((1, 16, 2, 4), 3, 2),
                                            ((3, 8, 6, 5), 3, 1)])
def test_int8_gemm_operands_give_the_plain_sums(shape, k, stride):
    """The card route's layout, held on the CPU (where ``torch._int_mm``
    also runs): the im2col rows times the kernel rows equal the plain
    version's sums, with K padded to a multiple of 8 (conv1's 294 -> 296)
    and M padded past 16 rows (a 1x2 output)."""
    g = torch.Generator().manual_seed(k)
    xq = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    kq = torch.randint(-127, 128, (16, shape[1], k, k), generator=g, dtype=torch.int8)
    a, b, (B, Ho, Wo) = encoders.int8_gemm_operands(xq, kq, stride, (k - 1) // 2)
    assert a.shape[1] % 8 == 0 and a.shape[1] >= shape[1] * k * k and a.shape[0] > 16
    acc = torch._int_mm(a, b.t())[:B * Ho * Wo].reshape(B, Ho, Wo, -1).permute(0, 3, 1, 2)
    assert torch.equal(acc, encoders.int8_accumulate_plain(xq, kq, stride, (k - 1) // 2))


def test_int8_lanes_are_independent():
    """The case of tests/test_quant.py::test_batch_independence: a lane's
    output is unchanged, bit for bit, when a 100x lane or a zero lane
    shares its batch."""
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.standard_normal((1, 8, 16, 16)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((16, 8, 3, 3))).astype(np.float32))
    alone = encoders.int8_conv(x0, w, 1, 1, use_kernels=False)
    for other in (100.0 * torch.ones_like(x0), torch.zeros_like(x0)):
        together = encoders.int8_conv(torch.cat([x0, other]), w, 1, 1, use_kernels=False)
        assert torch.equal(together[:1], alone)
        assert torch.isfinite(together).all()


# Held against JAX's int8 encoders evaluated op by op (not under jax.jit),
# the functions as written. JAX and the port then compute each trunk block
# in the same float32 operations but for the order of the convs' and
# BatchNorm's sums; an activation within rounding of a half-integer step
# of its int8 grid could take the other integer. On these inputs none
# does: the features differ by 5.3e-7 (image) and 8.7e-7 (IMU) of their
# largest entry, float32 rounding; the bound leaves 11x room. (Under
# jax.jit, XLA's fusion rounds the rescale and BatchNorm otherwise and
# integers do flip downstream: JAX's jitted image features differ from its
# own op-by-op ones by 3.1e-2 of the largest, and from the port's by the
# same.)
INT8_FEATURE_RTOL = 1e-5


def test_int8_encoders_match_jax(tiny):
    """JAX's int8 encoders on JAX's value-folded variables against the
    port's on the port's value fold of the bridged weights (the int8 conv
    quantizes the folded kernel in both), float32."""
    jc, tc, variables, sd = tiny
    import dataclasses

    from ode_vio_tpu.models.deepvio import create_model

    jm8 = create_model(dataclasses.replace(
        jc, model=dataclasses.replace(jc.model, encoder_int8=True)))
    img, imu, _ = batch([9])
    want = jm8.apply(jax_fold_batchnorm(variables), jnp.asarray(img), jnp.asarray(imu),
                     train=False, method="encode", rngs=RNGS)
    with torch.no_grad():
        got = port_model(tc, fold_batchnorm(sd), encoder_int8=True).encode(
            torch.from_numpy(img), torch.from_numpy(imu))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=INT8_FEATURE_RTOL * np.abs(w).max())
    # and close to the float features (JAX's bound, tests/test_quant.py:107)
    with torch.no_grad():
        fv = port_model(tc, sd).Image_net(torch.from_numpy(img))
    assert np.corrcoef(fv.numpy().ravel(), got[0].numpy().ravel())[0, 1] > 0.99


def test_int8_infer_fn_folds_by_value(tiny):
    """``make_infer_fn(fold_bn=True)`` with ``encoder_int8`` keeps the
    BatchNorm slots (value fold), and its poses equal a model loaded with
    the port's value fold."""
    _, tc, _, sd = tiny
    model = port_model(tc, sd, encoder_int8=True)
    infer = make_infer_fn(model, fold_bn=True, device="cpu")
    img, imu, ts = (torch.from_numpy(a) for a in batch([11, 12]))
    poses, _ = infer(img, imu, ts)
    with torch.no_grad():
        want = port_model(tc, fold_batchnorm(sd), encoder_int8=True)(img, imu, ts)[0]
    assert torch.equal(poses, want)


def test_int8_train_mode_is_the_float_path(tiny):
    """Training never quantizes: train-mode features of the int8
    configuration equal the float configuration's bit for bit (the same
    generator seed draws the same dropout)."""
    _, tc, _, sd = tiny
    img, imu, _ = (torch.from_numpy(a) for a in batch([13, 14]))
    outs = []
    for int8 in (False, True):
        model = port_model(tc, sd, encoder_int8=int8).train()
        outs.append(model.encode(img, imu, torch.Generator().manual_seed(5)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)

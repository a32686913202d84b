"""The port's registration track, the slice as a whole, against the JAX
package on the CPU: the quaternion algebra and rigid transforms, the
rotated-pair dataset, PCRNet's carried weights and forward, its losses,
one PCRNet step and one sampler step against the frozen PCRNet,
iterative registration, the eval step, precision AUC, the padded
evaluation, and the CLI's two phases.

Set-up: JAX-initialised PCRNet and sampler, carried into the port with
`pcrnet_state_dict_from_jax` and `samplenet_state_dict_from_jax`; inputs
from numpy seeds. Small sizes: B=4 pairs of N=64 points, m=16, the
sampler's bottleneck 32, k=4; PCRNet at its fixed widths (bottleneck
1024, FC 2048-1024-1024-512-512-256-7).

Tolerances, and why:
  * quaternion and transform values rtol 1e-6 with an atol of 1e-7 (a
    few f32 ulps: XLA's and torch's sin, cos, atan2 and asin round alike
    to within one or two ulps, and a component near zero after a
    cancellation keeps only the absolute error), 1e-6 for the transforms
    of points (terms of order 2 cancel to a small coordinate, and XLA
    may fuse a multiply-add where torch rounds twice); gradients rtol
    1e-5 / atol 1e-6, the values' round-off after one more pass;
  * the dataset: twists and p1 rtol 1e-6 (p1 from the twists), noise
    and batch order equal (numpy draws);
  * carried weights equal; PCRNet's twist and pre-quaternion rtol 1e-5,
    with an atol of 1e-5 of the output's largest entry (eleven f32
    layers with sums of up to 2048 terms in another order leave about
    1e-6 of scale, which a small translation entry cannot hold
    relatively);
  * loss terms rtol 1e-4; gradients rtol 1e-3 with an atol of 1e-4 of
    the tensor's largest entry, as test_torch_port_train_step.py holds
    the classification step (f32 round-off through a chain at random
    initialisation needs a floor tied to the scale);
  * new running statistics rtol 1e-4 / atol 1e-6; updated parameters
    atol 1e-6 where JAX's gradient is resolved (above 1e-4 of its
    tensor's largest entry), Adam's first step being +-lr there;
  * the eval step's rotation errors and consistency rtol 1e-4 (atol
    1e-9 on the consistency of full clouds, whose exact value is 0).
Left out of the sampler's parameter comparison: the dense biases before
each BN and the last conv BN's beta, whose gradient is zero in exact
arithmetic (ROADMAP, round-off gradients); their gradients are held to
be round-off on both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samplenet_tpu.geometry as jg
import samplenet_tpu.geometry.transforms as jT
from samplenet_tpu.data import pctransforms as jpct
from samplenet_tpu.data.qdataset import (
    QuaternionFixedDataset as JaxQuaternionFixedDataset,
)
from samplenet_tpu.interop.torch_import import pcrnet_to_torch
from samplenet_tpu.models.samplenet import FPSSampler as JaxFPSSampler
from samplenet_tpu.models.samplenet import SampleNet as JaxSampleNet
from samplenet_tpu.train import registration as jr
from samplenet_tpu.train import train_registration as jcli
from samplenet_tpu.train.state import clone_state
from samplenet_tpu_torch import geometry as pg
from samplenet_tpu_torch.data import QuaternionFixedDataset, save_h5
from samplenet_tpu_torch.data import pctransforms as ppct
from samplenet_tpu_torch.geometry import transforms as pT
from samplenet_tpu_torch.interop import (
    infer_pcrnet_config,
    pcrnet_state_dict_from_jax,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.models import FPSSampler, PCRNet
from samplenet_tpu_torch.train import checkpoints
from samplenet_tpu_torch.train import registration as pr
from samplenet_tpu_torch.train import train_registration as pcli

torch.set_num_threads(1)

B, N, M, BNECK, K = 4, 64, 16, 32, 4
KW = dict(num_points=N, num_out_points=M, bottleneck_size=BNECK,
          group_size=K, batch_size=B)
SN_CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-6, atol=1e-7, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _unit_quats(rng, n):
    q = rng.randn(n, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _twists(rng, n, trans=0.3):
    return np.concatenate([_unit_quats(rng, n), trans * rng.randn(n, 3)],
                          -1).astype(np.float32)


# ------------------------------------------------- quaternions, transforms

def _quaternion_cases():
    """name -> (port fn, JAX fn, numpy inputs): each takes the inputs as
    tensors or jax arrays and returns one array."""
    rng = np.random.RandomState(0)
    q, r = _unit_quats(rng, 6), _unit_quats(rng, 6)
    v = rng.randn(6, 3).astype(np.float32)
    e = rng.uniform(-0.6, 0.6, (6, 3)).astype(np.float32)
    cases = {
        "qmul": (pg.qmul, jg.qmul, (q, r)),
        "qrot": (pg.qrot, jg.qrot, (q, v)),
        "qinv": (pg.qinv, jg.qinv, (q,)),
        "expmap": (pg.expmap_to_quaternion, jg.expmap_to_quaternion, (e,)),
        "rotation_matrix": (pg.quaternion_to_rotation_matrix,
                            jg.quaternion_to_rotation_matrix, (q,)),
    }
    for order in ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx"):
        cases[f"qeuler_{order}"] = (
            lambda a, o=order: pg.qeuler(a, o),
            lambda a, o=order: jg.qeuler(a, o), (q,))
        cases[f"euler_to_quaternion_{order}"] = (
            lambda a, o=order: pg.euler_to_quaternion(a, o),
            lambda a, o=order: jg.euler_to_quaternion(a, o), (e,))
    return cases


QUAT_CASES = _quaternion_cases()


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternion_function_matches_jax(name):
    pfn, jfn, args = QUAT_CASES[name]
    _close(pfn(*map(_t, args)), jfn(*map(jnp.asarray, args)), msg=name)


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternion_function_gradient_matches_jax(name):
    """d/d inputs of sum(f(inputs) * w), autograd against jax.grad."""
    pfn, jfn, args = QUAT_CASES[name]
    out = np.asarray(jfn(*map(jnp.asarray, args)))
    w = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                      argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    targs = [_t(a).requires_grad_(True) for a in args]
    (pfn(*targs) * _t(w)).sum().backward()
    for got, want in zip(targs, jgrads):
        _close(got.grad, want, rtol=1e-5, atol=1e-6, msg=name)


def test_qfix_and_angle_units_match_jax():
    rng = np.random.RandomState(2)
    q = rng.randn(7, 3, 4)
    np.testing.assert_array_equal(pg.qfix(q), jg.qfix(q))
    deg = rng.uniform(-180, 180, 5)
    np.testing.assert_array_equal(pg.deg_to_rad(deg), jg.deg_to_rad(deg))
    np.testing.assert_array_equal(pg.rad_to_deg(deg), jg.rad_to_deg(deg))


def _transform_cases():
    rng = np.random.RandomState(3)
    a, b = _twists(rng, B), _twists(rng, B)
    p, p2 = rng.randn(B, 50, 3).astype(np.float32), \
        rng.randn(50, 3).astype(np.float32)
    one = _twists(rng, 1)

    def both(fn):
        return (lambda: fn(pT.QuaternionTransform, _t),
                lambda: fn(jT.QuaternionTransform, jnp.asarray))

    return {
        "inverse": both(lambda T, f: T(f(a)).inverse().vec),
        "rotate": both(lambda T, f: T(f(a)).rotate(f(p))),
        "rotate_one_cloud": both(lambda T, f: T(f(one)).rotate(f(p2))),
        "apply": both(lambda T, f: T(f(a)).apply(f(p))),
        "apply_inverse": both(lambda T, f: T(f(a)).inverse().apply(f(p))),
        "rotation_errors": both(
            lambda T, f: T(f(a)).rotation_errors(T(f(b)))),
        "compute_errors": both(
            lambda T, f: [e for e in T(f(a)).compute_errors(T(f(b)))]),
    }


TRANSFORM_CASES = _transform_cases()


@pytest.mark.parametrize("name", sorted(TRANSFORM_CASES))
def test_quaternion_transform_matches_jax(name):
    pfn, jfn = TRANSFORM_CASES[name]
    got, want = pfn(), jfn()
    for g, w in zip(*((got, want) if isinstance(got, list)
                      else ([got], [want]))):
        _close(g, w, atol=1e-6, msg=name)


def test_norm_error_gradient_matches_jax():
    """compute_errors' norm error is differentiated at loss_type 0."""
    rng = np.random.RandomState(4)
    a, b = _twists(rng, B), _twists(rng, B)
    jgrad = jax.grad(lambda v: jT.QuaternionTransform(v).compute_errors(
        jT.QuaternionTransform(jnp.asarray(b)))[1])(jnp.asarray(a))
    v = _t(a).requires_grad_(True)
    pT.QuaternionTransform(v).compute_errors(
        pT.QuaternionTransform(_t(b)))[1].backward()
    _close(v.grad, jgrad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("max_rot,max_trans", [(45.0, 0.0), (90.0, 0.5)])
def test_create_random_transform_matches_jax(max_rot, max_trans):
    prng, jrng = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(8):
        got = pT.create_random_transform(prng, max_rot, max_trans)
        want = jT.create_random_transform(jrng, max_rot, max_trans)
        assert got.dtype == want.dtype == np.float32
        _close(got, want)
    assert prng.randint(1 << 30) == jrng.randint(1 << 30)  # same draws


def _property_cases():
    """tests/test_registration.py's properties, on the port alone."""
    rng = np.random.RandomState(21)

    def t(a):
        return _t(np.asarray(a, np.float32))

    def qmul_identity():
        q = t(_unit_quats(rng, 5))
        ident = t(np.tile([1, 0, 0, 0], (5, 1)))
        _close(pg.qmul(ident, q), q)
        _close(pg.qmul(q, ident), q)

    def qmul_composes_rotations():
        q1, q2 = t(_unit_quats(rng, 4)), t(_unit_quats(rng, 4))
        r = pg.quaternion_to_rotation_matrix
        _close(r(pg.qmul(q1, q2)), torch.einsum("bij,bjk->bik", r(q1), r(q2)),
               atol=1e-5)

    def qrot_matches_matrix():
        q, v = t(_unit_quats(rng, 6)), t(rng.randn(6, 3))
        _close(pg.qrot(q, v), torch.einsum(
            "bij,bj->bi", pg.quaternion_to_rotation_matrix(q), v), atol=1e-5)

    def qinv_round_trip():
        q, v = t(_unit_quats(rng, 5)), t(rng.randn(5, 3))
        _close(pg.qrot(pg.qinv(q), pg.qrot(q, v)), v, atol=1e-5)

    def euler_round_trip():
        e = t(rng.uniform(-0.5, 0.5, (8, 3)))
        q = pg.euler_to_quaternion(e, "xyz")
        _close(q.norm(dim=-1), np.ones(8), atol=1e-5)
        _close(pg.qeuler(q, "xyz"), e, atol=1e-4)

    def expmap_known_values():
        q = pg.expmap_to_quaternion(t([[0, 0, 0], [np.pi, 0, 0]]))
        _close(q, [[1, 0, 0, 0], [0, 1, 0, 0]], atol=1e-6)

    def qfix_makes_signs_continuous():
        fixed = pg.qfix(np.array([[[1, 0, 0, 0.0]], [[-1, 0, 0, 0]],
                                  [[1, 0, 0, 0]]]))
        assert (np.sum(fixed[1:] * fixed[:-1], axis=-1) >= 0).all()

    def rotate_inverse_round_trip():
        tr = pT.QuaternionTransform(t(_twists(rng, 3, trans=0.0)))
        p = t(rng.randn(3, 100, 3))
        _close(tr.inverse().rotate(tr.rotate(p)), p, atol=1e-5)

    def errors_zero_for_identical():
        tr = pT.QuaternionTransform(t(_twists(rng, 4)))
        rot, norm, trans = tr.compute_errors(tr)
        assert float(rot) < 1e-2 and float(norm) < 1e-9 and \
            float(trans) < 1e-9

    def rotation_error_known_angle():
        # the PCN formula reports twice the geodesic angle: pi for 90 deg
        half = np.cos(np.pi / 4), np.sin(np.pi / 4)
        rot, _, _ = pT.QuaternionTransform(t([[1, 0, 0, 0, 0, 0, 0]])) \
            .compute_errors(pT.QuaternionTransform(
                t([[half[0], half[1], 0, 0, 0, 0, 0]])))
        assert float(rot) == pytest.approx(np.pi, rel=1e-3)

    def dataset_twist_maps_p0_to_p1():
        ds = QuaternionFixedDataset(rng.randn(2, 32, 3), seed=0)
        p0, p1, tw = ds[1]
        _close(pT.QuaternionTransform(t(tw[None])).rotate(t(p0[None]))[0],
               p1, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(p0, axis=-1),
                                   np.linalg.norm(p1, axis=-1), atol=1e-4)

    def consistency_zero_for_perfect_samples():
        p0s = t(rng.randn(2, 16, 3))
        vec = t(_twists(rng, 2, trans=0.0))
        c = pr.sampling_consistency(
            p0s, pT.QuaternionTransform(vec).rotate(p0s), vec)
        assert c.shape == (2,) and float(c.max()) < 1e-8

    def composition_is_unit_quaternion():
        net = PCRNet(bottleneck_size=32)
        with torch.no_grad():
            est = pr.register_iterative(net, t(rng.randn(4, 64, 3)),
                                        t(rng.randn(4, 64, 3)), 3)
        _close(est.quat.norm(dim=-1), np.ones(4), atol=1e-4)

    def iteration_matched_step_is_finite():
        cfg = pr.RegistrationConfig(num_points=N, batch_size=4,
                                    train_iterations=2)
        net, state = pr.create_pcrnet_state(cfg, device="cpu")
        before = net.fc6.weight.detach().clone()
        info = pr.make_pcrnet_train_step(net, cfg)(
            state, t(rng.randn(4, 64, 3)), t(rng.randn(4, 64, 3)),
            t(np.tile([1.0, 0, 0, 0, 0, 0, 0], (4, 1))))
        assert bool(torch.isfinite(info["loss"]))
        assert float(info["qnorm_loss"]) == 0.0
        assert not torch.equal(net.fc6.weight, before)

    return {f.__name__: f for f in (
        qmul_identity, qmul_composes_rotations, qrot_matches_matrix,
        qinv_round_trip, euler_round_trip, expmap_known_values,
        qfix_makes_signs_continuous, rotate_inverse_round_trip,
        errors_zero_for_identical, rotation_error_known_angle,
        dataset_twist_maps_p0_to_p1, consistency_zero_for_perfect_samples,
        composition_is_unit_quaternion, iteration_matched_step_is_finite)}


PROPERTY_CASES = _property_cases()


@pytest.mark.parametrize("name", sorted(PROPERTY_CASES))
def test_port_property(name):
    PROPERTY_CASES[name]()


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("noise", ["none", "fresh", "fixed"])
def test_qdataset_matches_jax(noise):
    data = np.random.RandomState(6).randn(5, 32, 3).astype(np.float32)
    kw = dict(repeat=2, seed=3, apply_noise=noise != "none",
              fixed_noise=noise == "fixed")
    got, want = QuaternionFixedDataset(data, **kw), \
        JaxQuaternionFixedDataset(data, **kw)
    assert len(got) == len(want) == 10
    _close(got.twists, want.twists)
    if noise == "fixed":
        np.testing.assert_array_equal(got.noise, want.noise)
    for i in (0, 3, 9, 4):          # fresh noise: the same draws in order
        g, w = got[i], want[i]
        np.testing.assert_array_equal(g[0], w[0])
        _close(g[1], w[1])
        _close(g[2], w[2])
    pb = list(got.batches(3, rng=np.random.RandomState(7)))
    jb = list(want.batches(3, rng=np.random.RandomState(7)))
    assert len(pb) == len(jb) == 3
    for (gp0, _, gt), (wp0, _, wt) in zip(pb, jb):
        np.testing.assert_array_equal(gp0, wp0)     # the same order
        _close(gt, wt)
    tail = list(got.batches(4, shuffle=False, drop_last=False))
    assert [len(b[0]) for b in tail] == [4, 4, 2]


def test_pctransforms_match_jax():
    pts = np.random.RandomState(8).randn(40, 3).astype(np.float32)
    names = ("PointcloudScale", "PointcloudRotate",
             "PointcloudRotatePerturbation", "PointcloudJitter",
             "PointcloudTranslate", "PointcloudRandomInputDropout",
             "OnUnitCube")
    for name in names:
        got = getattr(ppct, name)()(pts, np.random.RandomState(9))
        want = getattr(jpct, name)()(pts, np.random.RandomState(9))
        np.testing.assert_array_equal(got, want, err_msg=name)
    chain = [ppct.Compose(*(getattr(ppct, n)() for n in names[:4])),
             jpct.Compose(*(getattr(jpct, n)() for n in names[:4]))]
    got, want = (c(pts, np.random.RandomState(10)) for c in chain)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- PCRNet

@pytest.fixture(scope="module")
def pcrnet_pair():
    """A JAX-initialised PCRNet (through create_pcrnet_state, so at
    bottleneck 1024), its state and the port's PCRNet on its weights."""
    cfg = jr.RegistrationConfig(**KW)
    jmodel, jstate = jr.create_pcrnet_state(cfg, jax.random.PRNGKey(0))
    v = {"params": _np(jstate.params)}
    port = PCRNet()
    port.load_state_dict(_sd(pcrnet_state_dict_from_jax(v)))
    return jmodel, jstate, v, port


def _pairs(seed, b=B, n=N):
    rng = np.random.RandomState(seed)
    p0 = (0.5 * rng.randn(b, n, 3)).astype(np.float32)
    tw = _twists(rng, b, trans=0.0)
    p1 = np.asarray(jT.QuaternionTransform(jnp.asarray(tw)).rotate(
        jnp.asarray(p0)))
    p1 = (p1 + 0.01 * rng.randn(*p1.shape)).astype(np.float32)
    return p0, p1, tw


def test_carried_weights_equal_pcrnet_to_torch(pcrnet_pair):
    _, _, v, port = pcrnet_pair
    want = pcrnet_to_torch(v)
    got = pcrnet_state_dict_from_jax(v)
    assert sorted(got) == sorted(want) == sorted(port.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert infer_pcrnet_config(got) == {"bottleneck_size": 1024}
    assert got["fc1.weight"].shape == (1024, 2048)
    assert got["fc6.weight"].shape == (7, 256)


def test_pcrnet_forward_matches_jax(pcrnet_pair):
    jmodel, _, v, port = pcrnet_pair
    p0, p1, _ = _pairs(11)
    jt, jq = jmodel.apply(v, jnp.asarray(p0), jnp.asarray(p1))
    with torch.no_grad():
        pt, pq = port(_t(p0), _t(p1))
    for got, want in ((pt, jt), (pq, jq)):
        _close(got, want, rtol=1e-5, atol=1e-5 * float(jnp.abs(want).max()))
    _close(pt[:, :4].norm(dim=-1), np.ones(B), rtol=1e-6, atol=0)


def test_pcrnet_init_is_flax_style_and_seeded():
    a, b = PCRNet(bottleneck_size=32, generator=torch.Generator()
                  .manual_seed(1)), PCRNet(bottleneck_size=32,
                                           generator=torch.Generator()
                                           .manual_seed(1))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
        if k.endswith("bias"):
            assert not x.any(), k
    w = a.feat.conv5.weight            # lecun normal: std sqrt(1 / fan_in)
    assert abs(float(w.detach().std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert not hasattr(a.feat, "bn1")


def _grads_close(port_model, jgrads, cancelled=()):
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, p in port_model.named_parameters():
        got, want = p.grad.numpy(), jgrads[name]
        if name in cancelled:
            assert float(np.abs(got).max()) < 1e-5 * scale, name
            assert float(np.abs(want).max()) < 1e-5 * scale, name
            continue
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-4 * float(np.abs(want).max()),
            err_msg=name)


def _updated_close(port_model, jnew, jgrads, cancelled=()):
    for name, v in port_model.state_dict().items():
        if name.endswith("num_batches_tracked") or name in cancelled:
            continue
        if "running_" in name:
            np.testing.assert_allclose(v.numpy(), jnew[name], rtol=1e-4,
                                       atol=1e-6, err_msg=name)
            continue
        g = np.abs(jgrads[name])
        resolved = g > 1e-4 * g.max()
        np.testing.assert_allclose(v.numpy()[resolved], jnew[name][resolved],
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("loss_type", [0, 1])
def test_pcrnet_losses_and_gradients_match_jax(pcrnet_pair, loss_type,
                                              iterations):
    jmodel, jstate, v, _ = pcrnet_pair
    p0, p1, tw = _pairs(12)
    args = (jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(tw))

    def loss_fn(params):
        return jr.pcrnet_losses(jmodel, {"params": params}, *args, loss_type,
                                iterations)

    (jloss, jinfo), jg_ = jax.value_and_grad(loss_fn, has_aux=True)(
        jstate.params)
    jgrads = pcrnet_state_dict_from_jax({"params": _np(jg_)})
    port = PCRNet()
    port.load_state_dict(_sd(pcrnet_state_dict_from_jax(v)))
    loss, info = pr.pcrnet_losses(port, _t(p0), _t(p1), _t(tw), loss_type,
                                  iterations)
    loss.backward()
    _close(loss.detach(), jloss, rtol=1e-4, atol=0)
    for k, want in jinfo.items():
        _close(info[k], want, rtol=1e-4, atol=1e-7 if k == "qnorm_loss"
               else 0, msg=k)
    _grads_close(port, jgrads)


def test_pcrnet_train_step_matches_jax(pcrnet_pair):
    jmodel, jstate, v, _ = pcrnet_pair
    p0, p1, tw = _pairs(13)
    args = (jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(tw))
    cfg_j = jr.RegistrationConfig(**KW)
    jgrads = pcrnet_state_dict_from_jax({"params": _np(jax.grad(
        lambda p: jr.pcrnet_losses(jmodel, {"params": p}, *args, 0)[0])(
            jstate.params))})
    jnew, jinfo = jr.make_pcrnet_train_step(jmodel, cfg_j)(
        clone_state(jstate), *args)
    jnewsd = pcrnet_state_dict_from_jax({"params": _np(jnew.params)})

    cfg = pr.RegistrationConfig(**KW)
    port, state = pr.create_pcrnet_state(cfg, device="cpu")
    port.load_state_dict(_sd(pcrnet_state_dict_from_jax(v)))
    info = pr.make_pcrnet_train_step(port, cfg)(state, _t(p0), _t(p1),
                                                _t(tw))
    assert sorted(info) == sorted(jinfo)
    for k in jinfo:
        _close(info[k], jinfo[k], rtol=1e-4, atol=0, msg=k)
    assert state.step == 1 and state.optimizer.count == 1
    _grads_close(port, jgrads)
    _updated_close(port, jnewsd, jgrads)


def test_pcrnet_state_ignores_the_samplers_bottleneck():
    model, _ = pr.create_pcrnet_state(pr.RegistrationConfig(**KW),
                                      device="cpu")
    assert model.bottleneck_size == 1024 and BNECK != 1024


# ------------------------------------------ the sampler against the PCRNet

def _jax_sampler_grads(sampler, pcrnet, pcr_vars, cfg, state, p0, p1, tw):
    """The gradient of the JAX sampler step's loss
    (registration.py:161-193)."""
    def loss_fn(params):
        variables = {"params": params, "batch_stats": state.batch_stats}
        (s1p, p1_proj), upd = sampler.apply(variables, p1, training=True,
                                            mutable=["batch_stats"])
        s1 = sampler.apply(variables, p1, s1p, cfg.num_out_points, 1.0, 0.0,
                           method=JaxSampleNet.get_simplification_loss)
        if cfg.num_sampled_clouds == 2:
            (s0p, p0_proj), _ = sampler.apply(
                {"params": params, "batch_stats": upd["batch_stats"]}, p0,
                training=True, mutable=["batch_stats"])
            s0 = sampler.apply(variables, p0, s0p, cfg.num_out_points, 1.0,
                               0.0,
                               method=JaxSampleNet.get_simplification_loss)
            simp, sampled = 0.5 * (s1 + s0), (p0_proj, p1_proj)
        else:
            simp, sampled = s1, (p0, p1_proj)
        proj = sampler.apply(variables,
                             method=JaxSampleNet.get_projection_loss)
        task, _ = jr.pcrnet_losses(pcrnet, pcr_vars, *sampled, tw,
                                   cfg.loss_type, cfg.train_iterations)
        return task + cfg.alpha * simp + cfg.lmbda * proj

    return jax.grad(loss_fn)(state.params)


@pytest.fixture(scope="module", params=[2, 1], ids=["two_clouds",
                                                    "one_cloud"])
def sampler_steps(request, pcrnet_pair):
    jmodel, _, v, _ = pcrnet_pair
    ncl = request.param
    p0, p1, tw = _pairs(14)
    args = (jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(tw))
    jcfg = jr.RegistrationConfig(**KW, num_sampled_clouds=ncl)
    jsampler, jstate = jr.create_sampler_state(jcfg, jax.random.PRNGKey(1))
    v0 = {"params": _np(jstate.params),
          "batch_stats": _np(jstate.batch_stats)}
    jgrads = samplenet_state_dict_from_jax(
        {"params": _np(_jax_sampler_grads(jsampler, jmodel, v, jcfg, jstate,
                                          *args)),
         "batch_stats": v0["batch_stats"]})
    jnew, jinfo = jr.make_sampler_train_step(jsampler, jmodel, v, jcfg)(
        clone_state(jstate), *args)
    jnewsd = samplenet_state_dict_from_jax(
        {"params": _np(jnew.params), "batch_stats": _np(jnew.batch_stats)})

    cfg = pr.RegistrationConfig(**KW, num_sampled_clouds=ncl)
    port, state = pr.create_sampler_state(cfg, device="cpu")
    port.load_state_dict(_sd(samplenet_state_dict_from_jax(v0)))
    pcrnet = PCRNet()
    pcrnet.load_state_dict(_sd(pcrnet_state_dict_from_jax(v)))
    info = pr.make_sampler_train_step(port, pcrnet, cfg)(
        state, _t(p0), _t(p1), _t(tw))
    return dict(info=info, jinfo=jinfo, port=port, state=state,
                pcrnet=pcrnet, jgrads=jgrads, jnew=jnewsd, v0=v0, ncl=ncl)


def test_sampler_step_loss_terms_match_jax(sampler_steps):
    s = sampler_steps
    assert sorted(s["info"]) == sorted(s["jinfo"])
    for k, want in s["jinfo"].items():
        _close(s["info"][k], want, rtol=1e-4, atol=1e-7, msg=k)
    assert float(s["info"]["simplification_loss"]) > 0
    assert s["state"].step == 1 and s["state"].optimizer.count == 1


def test_sampler_step_gradients_match_jax(sampler_steps):
    s = sampler_steps
    _grads_close(s["port"], s["jgrads"], SN_CANCELLED)
    for name in SN_CANCELLED:
        if name.startswith("conv"):
            assert not s["port"].get_parameter(name).grad.any(), name
    # PCRNet is frozen and passes the gradient through
    assert all(p.grad is None and not p.requires_grad
               for p in s["pcrnet"].parameters())


def test_sampler_step_chains_batch_statistics_and_updates_like_jax(
        sampler_steps):
    """Two clouds: the template's forward averages its statistics into the
    source's result, two averages a step; one cloud: one average."""
    s = sampler_steps
    _updated_close(s["port"], s["jnew"], s["jgrads"], SN_CANCELLED)
    tracked = int(s["port"].bn1.num_batches_tracked)
    assert tracked == s["ncl"]
    mean0 = s["v0"]["batch_stats"]["simplifier"]["convs"]["bn_0"]["mean"]
    assert not np.allclose(s["port"].bn1.running_mean.numpy(), mean0)


# ------------------------------------------------- registration and eval

@pytest.mark.parametrize("iterations", [1, 3])
def test_register_iterative_matches_jax(pcrnet_pair, iterations):
    jmodel, _, v, port = pcrnet_pair
    p0, p1, _ = _pairs(15)
    want = jr.register_iterative(jmodel, v, jnp.asarray(p0),
                                 jnp.asarray(p1), iterations)
    with torch.no_grad():
        got = pr.register_iterative(port, _t(p0), _t(p1), iterations)
    _close(got.vec, want.vec, rtol=1e-5, atol=1e-6)
    _close(got.quat.norm(dim=-1), np.ones(B), rtol=1e-5, atol=0)
    if iterations == 1:
        with torch.no_grad():
            twist, _ = port(_t(p0), _t(p1))
        torch.testing.assert_close(got.vec, twist, rtol=0, atol=0)


@pytest.fixture(scope="module")
def eval_setup(pcrnet_pair):
    jmodel, _, v, port = pcrnet_pair
    jcfg = jr.RegistrationConfig(**KW)
    jsampler, jstate = jr.create_sampler_state(jcfg, jax.random.PRNGKey(2))
    sv = {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}
    sampler, _ = pr.create_sampler_state(pr.RegistrationConfig(**KW),
                                         device="cpu")
    sampler.load_state_dict(_sd(samplenet_state_dict_from_jax(sv)))
    return dict(jmodel=jmodel, v=v, port=port, jsampler=jsampler, sv=sv,
                sampler=sampler)


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("which", ["samplenet", "fps", "none"])
def test_eval_step_matches_jax(eval_setup, which, iterations):
    e = eval_setup
    jcfg, cfg = jr.RegistrationConfig(**KW), pr.RegistrationConfig(**KW)
    if which == "samplenet":
        jsampler, jvars, sampler = e["jsampler"], e["sv"], e["sampler"]
    elif which == "fps":
        jsampler, sampler = JaxFPSSampler(M, permute=False), \
            FPSSampler(M, permute=False)
        jvars = jsampler.init(jax.random.PRNGKey(0), jnp.zeros((2, N, 3)))
    else:
        jsampler = jvars = sampler = None
    p0, p1, tw = _pairs(16)
    jr_, jt, jc = jr.make_eval_step(jsampler, e["jmodel"], e["v"], jcfg,
                                    iterations=iterations)(
        jvars, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(tw))
    r, t, c = pr.make_eval_step(sampler, e["port"], cfg,
                                iterations=iterations)(_t(p0), _t(p1), _t(tw))
    assert r.shape == c.shape == (B,)
    _close(r, jr_, rtol=1e-4, atol=0)
    _close(t, jt, rtol=1e-4, atol=0)
    _close(c, jc, rtol=1e-4, atol=1e-9)
    if which != "none":
        assert float(c.min()) > 1e-6     # sampled clouds are not exact


def test_fps_sampler_is_fps_from_its_start():
    from samplenet_tpu_torch.ops.fps import farthest_point_sample_with_points

    x = _t(np.random.RandomState(17).randn(3, 50, 3).astype(np.float32))
    y, same = FPSSampler(8, permute=False)(x)
    assert same is y
    torch.testing.assert_close(y, farthest_point_sample_with_points(8, x)[1],
                               rtol=0, atol=0)
    gen = torch.Generator().manual_seed(3)
    start = torch.randint(0, 50, (3,), generator=torch.Generator()
                          .manual_seed(3))
    yp, _ = FPSSampler(8)(x, generator=gen)
    torch.testing.assert_close(yp[:, 0], x[torch.arange(3), start])
    bcn, _ = FPSSampler(8, permute=False, input_shape="bcn",
                        output_shape="bcn")(x.transpose(1, 2))
    torch.testing.assert_close(bcn.transpose(1, 2), y, rtol=0, atol=0)
    assert float(FPSSampler(8).get_simplification_loss(x, y, 8)) == 0.0
    assert float(FPSSampler(8).get_projection_loss()) == 0.0


@pytest.mark.parametrize("errs", [[0.0, 10.0, 200.0], [0.5, 0.5, 179.9, 3.0],
                                  []])
def test_precision_auc_matches_jax(errs):
    errs = np.asarray(errs, np.float32)
    gc, ga = pr.precision_auc(errs)
    wc, wa = jr.precision_auc(errs)
    np.testing.assert_array_equal(gc, wc)
    assert ga == wa
    assert len(gc) == 360


def test_evaluate_pads_and_matches_jax(eval_setup):
    """Every metric is the same whether 4 divides the 10 pairs or not (3),
    and equals the JAX evaluation's."""
    e = eval_setup
    data = (0.5 * np.random.RandomState(18).randn(5, N, 3)).astype(
        np.float32)
    ds = QuaternionFixedDataset(data, repeat=2, seed=0)
    jds = JaxQuaternionFixedDataset(data, repeat=2, seed=0)
    cfg, jcfg = pr.RegistrationConfig(**KW), jr.RegistrationConfig(**KW)
    step = pr.make_eval_step(e["sampler"], e["port"], cfg)
    r4 = pr.evaluate(step, ds, 4, device="cpu")
    r3 = pr.evaluate(step, ds, 3, device="cpu")
    want = jr.evaluate(jr.make_eval_step(e["jsampler"], e["jmodel"], e["v"],
                                         jcfg), e["sv"], jds, 4)
    assert sorted(r4) == sorted(want)
    for key in want:
        assert r4[key] == pytest.approx(r3[key], rel=1e-5), key
        assert r4[key] == pytest.approx(want[key], rel=1e-4), key


# -------------------------------------------------------------------- CLI

def _cli_args(extra):
    return ["--epochs", "1", "--steps-per-epoch", "1", "--batch-size", "4",
            "--num-points", str(N), "--num-out-points", str(M),
            "--group-size", str(K), "--train-size", "8", "--test-size", "6",
            *extra]


@pytest.mark.parametrize("source", ["procedural", "category", "h5"])
def test_cli_datasets_match_jax(tmp_path, source):
    extra = []
    if source == "category":
        extra = ["--category", "3"]
    elif source == "h5":
        rng = np.random.RandomState(19)
        for split, n in (("train", 6), ("test", 5)):
            save_h5(str(tmp_path / f"car_{split}.h5"),
                    rng.randn(n, 80, 3).astype(np.float32),
                    np.zeros((n, 1), np.uint8))
        extra = ["--h5-dir", str(tmp_path)]
    argv = _cli_args(extra)
    got = pcli.build_datasets(pcli.parse_args(argv + ["--device", "cpu"]))
    want = jcli.build_datasets(jcli.parse_args(argv))
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_array_equal(g.data, w.data)
        _close(g.twists, w.twists)
    if source == "h5":
        assert got[0].data.shape == (6, N, 3) and len(got[0]) == 12


def _report_finite(report, keys):
    for key in keys:
        for metric in ("rot_err_mean", "rot_err_std", "auc",
                       "consistency_mean"):
            assert np.isfinite(report[key][metric]), (key, metric)
        assert 0.0 <= report[key]["auc"] <= 1.0


def test_cli_two_phases_on_cpu_with_h5(tmp_path, capsys):
    rng = np.random.RandomState(20)
    h5 = tmp_path / "h5"
    h5.mkdir()
    for split, n in (("train", 8), ("test", 5)):
        save_h5(str(h5 / f"car_{split}.h5"),
                (0.5 * rng.randn(n, N, 3)).astype(np.float32),
                np.zeros((n, 1), np.uint8))
    base = ["--device", "cpu", "--h5-dir", str(h5)]
    p1 = tmp_path / "pcrnet"
    state = pcli.main(_cli_args(base + [
        "--phase", "pcrnet", "--fps-eval-sizes", "8", "--iterations", "2",
        "--log-dir", str(p1)]))
    assert state.step == 1
    with open(p1 / "report.json") as f:
        report = json.load(f)
    _report_finite(report, [f"{w}_iter{i}" for w in ("full", "fps8", "fps16")
                            for i in (1, 2)])
    assert report["best_epoch"] == 0
    pcrnet = checkpoints.load_pcrnet(str(p1 / "ckpt"), "cpu")
    assert pcrnet.bottleneck_size == 1024
    p2 = tmp_path / "samplenet"
    state = pcli.main(_cli_args(base + [
        "--phase", "samplenet", "--pcrnet-ckpt", str(p1 / "ckpt"),
        "--iterations", "2", "--log-dir", str(p2)]))
    assert state.step == 1
    with open(p2 / "report.json") as f:
        report = json.load(f)
    _report_finite(report, ["best", "best_iter2"])
    sd = torch.load(p2 / "ckpt" / "sampler.pth", weights_only=True)
    assert sd["fc4.weight"].shape == (3 * M, 256)
    out = capsys.readouterr().out
    assert "frozen PCRNet from" in out and "eval: rot_err=" in out
    assert "nan" not in out.lower()


@pytest.mark.parametrize("phase", ["pcrnet", "samplenet"])
def test_cli_epochs_zero_falls_back_to_the_last_state(tmp_path, phase):
    pcr = tmp_path / "pcr"
    if phase == "samplenet":
        checkpoints.save_published(
            str(pcr), PCRNet().state_dict(), {"bottleneck_size": 1024},
            filename=checkpoints.PCRNET_FILE)
    pcli.main(_cli_args(["--device", "cpu", "--phase", phase, "--epochs",
                         "0", "--pcrnet-ckpt", str(pcr),
                         "--log-dir", str(tmp_path / "log")]))
    with open(tmp_path / "log" / "report.json") as f:
        report = json.load(f)
    assert report["best_epoch"] == -1
    name = "pcrnet.pth" if phase == "pcrnet" else "sampler.pth"
    assert (tmp_path / "log" / "ckpt" / name).exists()


def test_load_pcrnet_refuses_a_config_that_disagrees(tmp_path):
    checkpoints.save_published(str(tmp_path), PCRNet(
        bottleneck_size=32).state_dict(), {"bottleneck_size": 1024},
        filename=checkpoints.PCRNET_FILE)
    with pytest.raises(ValueError, match="config.json says"):
        checkpoints.load_pcrnet(str(tmp_path), "cpu")


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.main(["--device", "cuda"])
    assert pcli.parse_args([]).device == "cuda"

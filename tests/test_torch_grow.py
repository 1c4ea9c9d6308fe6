"""The port's grow mode held against the JAX package: the sphere codebook,
the straight-through argmax, the grow offsets, the speculative render set,
the commit-time grow and the grow densification round
(``tests/test_torch_grow_step.py`` holds the speculative training step);
and ``cli/train.py`` training in grow mode on the CPU.

Inputs are made from a seed with numpy and handed to both packages; every
random draw is made once by JAX and fed to the port as data. The JAX
functions are jitted whole. Tolerances are stated where they are used.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.models import gaussians as jgauss
from mvs_gaussian_splatting_tpu.models import grow as jgrow
from mvs_gaussian_splatting_tpu.train import optim as joptim
from mvs_gaussian_splatting_tpu.utils import sphere as jsphere
from mvs_gaussian_splatting_tpu_torch.models import gaussians as tgauss
from mvs_gaussian_splatting_tpu_torch.models import grow as tgrow
from mvs_gaussian_splatting_tpu_torch.train import optim as toptim
from mvs_gaussian_splatting_tpu_torch.utils import sphere as tsphere

torch.set_num_threads(1)

EXTRAS = ("grow_dir", "continous_dir", "grow_distance",
          "learn_split_distance", "learn_split_scale")
NUM_DIRS = 128
DIRS = jsphere.sphere_points(NUM_DIRS).astype(np.float32)
# the split and grow arithmetic: the same f32 expressions, a 3×3 rotation
# and a 3-term direction product summed in other orders (1e-6 of scale)
REL = 1e-6


def rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    return (float(np.abs(got - want).max()) / scale if scale
            else float(np.abs(got).max()))


def grow_state(n, capacity, seed, flags, prefix=False, scene=False):
    """numpy (params, mu, nu, aux) dicts with the extras of ``flags``: n
    alive rows (a prefix when ``prefix``), random direction logits,
    distances and split parameters, and a gradient statistic that makes
    about half the alive rows hot. ``scene``: the alive rows sit in front of
    the test camera."""
    rng = np.random.RandomState(seed)
    f = np.float32
    p = {"xyz": rng.randn(capacity, 3).astype(f) * 2,
         "f_dc": rng.randn(capacity, 1, 3).astype(f),
         "f_rest": (rng.randn(capacity, 15, 3) * 0.1).astype(f),
         "scaling": rng.uniform(-4, 0, (capacity, 3)).astype(f),
         "rotation": rng.randn(capacity, 4).astype(f),
         "opacity": rng.uniform(-6, 3, (capacity, 1)).astype(f)}
    if scene:
        z = rng.uniform(2, 6, capacity)
        p["xyz"] = np.stack([rng.uniform(-0.8, 0.8, capacity) * z,
                             rng.uniform(-0.6, 0.6, capacity) * z, z],
                            -1).astype(f)
        p["scaling"] = np.log(rng.uniform(0.04, 0.3, (capacity, 3))).astype(f)
        p["opacity"] = rng.uniform(-2, 3, (capacity, 1)).astype(f)
    extra = {"dirs_prob": (capacity, NUM_DIRS), "conti_dirs": (capacity, 3),
             "grow_dist": (capacity, 1), "split_distance": (capacity, 3),
             "split_scale": (capacity, 1)}
    for flag, (name, shape) in zip(EXTRAS, extra.items()):
        if flags.get(flag):
            p[name] = rng.randn(*shape).astype(f)
    mu = {k: np.zeros_like(v) for k, v in p.items()}
    nu = {k: np.zeros_like(v) for k, v in p.items()}
    alive = np.zeros(capacity, bool)
    if prefix:
        alive[:n] = True
    else:
        alive[rng.choice(capacity, n, replace=False)] = True
    aux = {"alive": alive,
           "max_radii2d": rng.randint(0, 30, capacity).astype(f),
           "xyz_grad_accum": (rng.rand(capacity) * 8e-4).astype(f),
           "denom": rng.randint(1, 4, capacity).astype(f)}
    return p, mu, nu, aux


def jax_state(p, mu, nu, aux, count=0):
    def tree(d):
        return jgauss.GaussianParams(**{k: jnp.asarray(v)
                                        for k, v in d.items()})
    return (tree(p), joptim.AdamState(count=jnp.asarray(count, jnp.int32),
                                      mu=tree(mu), nu=tree(nu)),
            jgauss.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()}))


def torch_state(p, mu, nu, aux, count=0):
    return (tgauss.params_from_numpy(p, "cpu"),
            toptim.adam_from_numpy(count, mu, nu, "cpu"),
            tgauss.aux_from_numpy(aux, "cpu"))


def configs(flags):
    return jgrow.GrowConfig(**flags), tgrow.GrowConfig(**flags)


def test_sphere_points():
    np.testing.assert_array_equal(tsphere.sphere_points(128),
                                  jsphere.sphere_points(128))
    np.testing.assert_array_equal(tsphere.sphere_points(7),
                                  jsphere.sphere_points(7))


def test_straight_through_argmax():
    rng = np.random.RandomState(0)
    logits = rng.randn(9, NUM_DIRS).astype(np.float32)
    logits[3] = 0.0                         # uniform: the first index wins
    logits[5, [7, 90]] = 9.0                # a tie at the top
    w = rng.randn(9, NUM_DIRS).astype(np.float32)
    jy, jg = jax.jit(jax.value_and_grad(
        lambda l: (jgrow.straight_through_argmax(l) * w).sum()))(
            jnp.asarray(logits))
    jfwd = np.asarray(jax.jit(jgrow.straight_through_argmax)(
        jnp.asarray(logits)))
    t = torch.tensor(logits, requires_grad=True)
    ty = tgrow.straight_through_argmax(t)
    (ty * torch.tensor(w)).sum().backward()
    # forward equal: the same one-hot, the same f32 expression around it
    np.testing.assert_array_equal(ty.detach().numpy(), jfwd)
    assert ty[3].argmax() == 0 and ty[5].argmax() == 7
    # gradient: the softmax Jacobian (1e-6 abs)
    assert float(np.abs(t.grad.numpy() - np.asarray(jg)).max()) <= 1e-6


@pytest.mark.parametrize("flags", [
    {"grow_dir": True},
    {"continous_dir": True},
    {"grow_dir": True, "grow_distance": True},
    {"continous_dir": True, "grow_distance": True},
], ids=["discrete", "continuous", "discrete_distance",
        "continuous_distance"])
def test_grow_offsets(flags):
    p, _, _, _ = grow_state(40, 64, seed=1, flags=flags)
    jcfg, tcfg = configs(flags)
    w = np.random.RandomState(2).randn(64, 3).astype(np.float32)
    jp = jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jdirs = jnp.asarray(DIRS)

    def jloss(params):
        off = jgrow.grow_offsets(params, jdirs, jcfg)
        return (off * w).sum(), off

    (_, joff), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = tgauss.GaussianParams(**{k: torch.tensor(v, requires_grad=True)
                                  for k, v in p.items()})
    toff = tgrow.grow_offsets(tp, torch.tensor(DIRS), tcfg)
    (toff * torch.tensor(w)).sum().backward()
    assert rel_gap(toff.detach().numpy(), joff) <= REL
    # gradients through the softmax / normalize and the scale's max (1e-6
    # of each leaf's scale)
    for k in p:
        want = getattr(jg, k)
        got = getattr(tp, k).grad
        got = np.zeros_like(want) if got is None else got.numpy()
        assert rel_gap(got, want) <= REL, k


AUGMENT_MODES = {
    "grow_only": {"grow_dir": True, "grow_distance": True},
    "split_distance": {"grow_dir": True, "learn_split_distance": True},
    "split_scale": {"continous_dir": True, "learn_split_scale": True},
    "split_only": {"learn_split_distance": True, "learn_split_scale": True},
}


def _assert_state(jout, tout):
    jinfo, tinfo = jout[4], tout[4]
    assert {k: int(v) for k, v in jinfo.items()} == tinfo
    for w, g in zip(jout[:4], tout[:4]):
        for k, v in w._asdict().items():
            if v is None:
                assert getattr(g, k) is None, k
                continue
            got = getattr(g, k).numpy()
            if v.dtype == jnp.bool_:
                np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
            else:
                # the copies are exact; the offsets go through a 3x3
                # rotation and the direction product (1e-6 abs)
                np.testing.assert_allclose(got, np.asarray(v), rtol=1e-6,
                                           atol=1e-6, err_msg=k)


GROW_ROUNDS = {
    "discrete_noise": {"grow_dir": True},
    "continuous_learned": {"continous_dir": True, "learn_split_distance": True,
                           "learn_split_scale": True},
    "continuous_notreinit": {"continous_dir": True, "grow_distance": True,
                             "learn_split_scale": True,
                             "prob_notreinit": True, "split_notreinit": True,
                             "symmetric_split": True},
}

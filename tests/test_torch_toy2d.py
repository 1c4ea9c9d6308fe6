"""The 2D toy held against the JAX package's (moved from
``test_torch_tools.py``, whose helpers it uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image
from test_torch_tools import (target_image)

from mvs_gaussian_splatting_tpu.toy2d import splat2d as jtoy
from mvs_gaussian_splatting_tpu_torch.toy2d import splat2d as ttoy

torch.set_num_threads(1)


class TestToy2D:
    def test_render_and_gradient_match_jax(self):
        """64 slots (32 alive) drawn by the JAX toy, rendered at 32×40 with
        a correlation term: the image within 1e-6 of the JAX package's, and
        the render's gradient for every parameter (its VJP with a seeded
        cotangent) within 1e-6 of that parameter's largest gradient. Dead
        slots stay black."""
        jp, jalive = jtoy.init_splats(jax.random.PRNGKey(0), 64, 32)
        rng = np.random.RandomState(0)
        jp = jp._replace(rho=jnp.asarray(
            rng.uniform(-1, 1, 64).astype(np.float32)))
        cot = rng.randn(3, 32, 40).astype(np.float32)

        @jax.jit
        def jref(p):
            img, vjp = jax.vjp(
                lambda q: jtoy.render_splats2d(q, jalive, 32, 40), p)
            return img, vjp(jnp.asarray(cot))[0]

        jimg, jgrad = jref(jp)
        params = ttoy.params_from_numpy(jp, device="cpu")
        alive = torch.tensor(np.asarray(jalive))
        leaves = [p.requires_grad_() for p in params]
        img = ttoy.render_splats2d(ttoy.Splat2DParams(*leaves), alive, 32, 40)
        np.testing.assert_allclose(img.detach().numpy(), jimg, atol=1e-6,
                                   rtol=0)
        grads = torch.autograd.grad(img, leaves, torch.from_numpy(cot))
        for name, g, want in zip(ttoy.Splat2DParams._fields, grads, jgrad):
            want = np.asarray(want)
            assert np.abs(want).max() > 0, name
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)
        with torch.no_grad():
            dark = ttoy.render_splats2d(params, torch.zeros_like(alive), 32,
                                        32)
        assert float(dark.abs().max()) == 0.0

    def test_fit_matches_jax_with_its_draws(self):
        """51 epochs on a 48×48 target at the toy's default learning rate,
        capacity 256 (64 alive), densifying at epochs 25 and 50, the JAX
        toy's initial splats and split jitters fed in: the logged losses
        (epochs 0 and 50) within 1e-5 and the alive counts and mask equal
        to the JAX fit's; the loss falls and the rounds grow the set. (At
        lr 0.02 or more Adam amplifies the two packages' last-bit
        differences until a densification threshold flips a splat.)"""
        tgt = target_image()
        kw = dict(capacity=256, n_init=64, epochs=51,
                  densification_interval=25, seed=0)
        _, jalive, jhist = jtoy.fit_image(tgt, **kw)
        # the JAX fit's draws: split once for the init, once a round
        key = jax.random.PRNGKey(0)
        key, sub = jax.random.split(key)
        jp, ja = jtoy.init_splats(sub, 256, 64)
        jitters = []
        for _ in range(2):
            key, sub = jax.random.split(key)
            jitters.append(torch.tensor(np.asarray(
                jax.random.normal(sub, (256, 2)))))
        init = (ttoy.params_from_numpy(jp, "cpu"),
                torch.tensor(np.asarray(ja)))
        _, alive, hist = ttoy.fit_image(tgt, device="cpu", init=init,
                                        jitters=jitters, **kw)
        assert hist["n_alive"] == jhist["n_alive"]
        np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
        np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5,
                                   rtol=0)
        assert hist["n_alive"][1] > hist["n_alive"][0]
        assert hist["loss"][-1] < 0.7 * hist["loss"][0]

    def test_fit_draws_from_its_seed(self):
        """Without draws given, one seed gives one fit."""
        tgt = target_image(24, 24)
        kw = dict(capacity=64, n_init=16, epochs=21,
                  densification_interval=10, device="cpu")
        runs = [ttoy.fit_image(tgt, seed=s, **kw)[2]["loss"]
                for s in (3, 3, 4)]
        assert runs[0] == runs[1] and runs[0] != runs[2]

    def test_cli_with_reference_config(self, tmp_path):
        """The script entry accepts the reference's config.yml keys
        (2D-Gaussian-Splatting-main/config.yml) and writes a fitted render."""
        import yaml

        rng = np.random.RandomState(0)
        img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "target.png")
        with open(tmp_path / "config.yml", "w") as f:
            yaml.safe_dump({
                "image_size": [32, 32, 3],
                "primary_samples": 50,
                "backup_samples": 100,
                "num_epochs": 30,
                "densification_interval": 20,
                "learning_rate": 0.02,
                "image_file_name": str(tmp_path / "target.png"),
                "gradient_threshold": 0.002,
                "gaussian_threshold": 0.75,
            }, f)
        out = str(tmp_path / "fit.png")
        ttoy.main(["--config", str(tmp_path / "config.yml"), "--out", out,
                   "--device", "cpu"])
        assert Image.open(out).size == (32, 32)

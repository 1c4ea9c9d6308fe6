"""Small ops (transforms, SH, activations) held against the JAX
package (moved from ``test_torch_ops.py``, whose helpers they
use)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import (t, close)

from mvs_gaussian_splatting_tpu.models import gaussians as jgs
from mvs_gaussian_splatting_tpu.utils import sh as jsh
from mvs_gaussian_splatting_tpu.utils import transforms as jtr
from mvs_gaussian_splatting_tpu_torch.models import gaussians as tgs
from mvs_gaussian_splatting_tpu_torch.utils import sh as tsh
from mvs_gaussian_splatting_tpu_torch.utils import transforms as ttr

torch.set_num_threads(1)


class TestSmallOps:
    def setup_method(self):
        rng = np.random.RandomState(0)
        self.q = rng.randn(50, 4).astype(np.float32)
        self.s = rng.uniform(0.01, 2.0, (50, 3)).astype(np.float32)
        self.x = rng.uniform(0.01, 0.99, 50).astype(np.float32)

    def test_transforms(self):
        q, s = self.q, self.s
        close(ttr.quat_to_rotmat(t(q)), jtr.quat_to_rotmat(q))
        close(ttr.build_scaling_rotation(t(s), t(q)),
              jtr.build_scaling_rotation(s, q))
        cov_t = ttr.covariance_from_scaling_rotation(t(s), t(q), 0.7)
        cov_j = jtr.covariance_from_scaling_rotation(s, q, 0.7)
        close(cov_t, cov_j)
        close(ttr.strip_symmetric(cov_t), jtr.strip_symmetric(cov_j))
        close(ttr.unstrip_symmetric(ttr.strip_symmetric(cov_t)), cov_j)
        close(ttr.inverse_sigmoid(t(self.x)), jtr.inverse_sigmoid(self.x),
              atol=1e-5)
        close(ttr.normalize(t(q)), jtr.normalize(q))

    @pytest.mark.parametrize("deg", [0, 1, 2, 3])
    def test_sh(self, deg):
        rng = np.random.RandomState(deg)
        d = rng.randn(40, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        sh = (rng.randn(40, 16, 3) * 0.5).astype(np.float32)
        close(tsh.sh_basis(deg, t(d)), jsh.sh_basis(deg, d))
        close(tsh.eval_sh(deg, t(sh), t(d)), jsh.eval_sh(deg, sh, d))
        rgb_t, cl_t = tsh.sh_to_rgb_clamped(deg, t(sh), t(d))
        rgb_j, cl_j = jsh.sh_to_rgb_clamped(deg, sh, d)
        close(rgb_t, rgb_j)
        np.testing.assert_array_equal(cl_t.numpy(), np.asarray(cl_j))
        close(tsh.sh2rgb(t(sh)), jsh.sh2rgb(sh))
        close(tsh.rgb2sh(t(self.x)), jsh.rgb2sh(self.x), atol=1e-5)

    def test_activated_and_params_from_numpy(self):
        rng = np.random.RandomState(3)
        n = 30
        jp = jgs.GaussianParams(
            xyz=jnp.asarray(rng.randn(n, 3).astype(np.float32)),
            f_dc=jnp.asarray(rng.randn(n, 1, 3).astype(np.float32)),
            f_rest=jnp.asarray(rng.randn(n, 15, 3).astype(np.float32)),
            scaling=jnp.asarray(rng.randn(n, 3).astype(np.float32)),
            rotation=jnp.asarray(rng.randn(n, 4).astype(np.float32)),
            opacity=jnp.asarray(rng.randn(n, 1).astype(np.float32)))
        tp = tgs.params_from_numpy(
            {k: np.asarray(v) for k, v in jp._asdict().items()
             if v is not None}, "cpu")
        assert tp.dirs_prob is None and tp.xyz.dtype == torch.float32
        for a, b in zip(tgs.activated(tp), jgs.activated(jp)):
            close(a, b)
        close(tgs.get_features(tp), jgs.get_features(jp))
        with pytest.raises(ValueError, match="unknown"):
            tgs.params_from_numpy({"xyzw": np.zeros(3)}, "cpu")

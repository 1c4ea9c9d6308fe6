"""Both packages' gradients held to a float64 evaluation of the same
operator, and preprocess's gradients at the camera plane (moved from
``test_torch_grad.py``, whose helpers and bounds they use)."""

import pytest
import torch
from test_torch_grad import BAD_POSITIONS, _camera_at_origin

from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess

torch.set_num_threads(1)


@pytest.mark.parametrize("bad", BAD_POSITIONS)
def test_preprocess_grads_finite_at_camera_plane(bad):
    cam = _camera_at_origin()
    means = torch.tensor([[0.0, 0.0, 5.0], bad], requires_grad=True)
    scales = torch.full((2, 3), 0.1, requires_grad=True)
    quats = torch.tensor([[1.0, 0, 0, 0]] * 2, requires_grad=True)
    opac = torch.tensor([0.9, 0.9], requires_grad=True)
    shs = torch.zeros((2, 16, 3))
    shs[:, 0] = 0.7
    shs.requires_grad_()
    p = preprocess(means, opac, cam, 64, 64, scales=scales, rotations=quats,
                   shs=shs, sh_degree=3)
    mask = p.mask[:, None]
    # touch every differentiable output the way the composite would
    loss = (torch.where(mask, p.xy, 0.0).sum()
            + torch.where(mask, p.conic, 0.0).sum()
            + torch.where(mask, p.rgb, 0.0).sum()
            + torch.where(p.mask, p.opacity, 0.0).sum()
            + torch.where(p.mask, p.depth, 0.0).sum())
    loss.backward()
    for t in (means, scales, quats, opac, shs):
        assert bool(torch.isfinite(t.grad).all()), t.grad
    assert bool(p.mask[0]) and not bool(p.mask[1])

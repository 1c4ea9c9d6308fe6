"""The port's harness entry points (``tools/graft_entry.py``) held against
the JAX repository's ``__graft_entry__.py`` on the CPU.

``entry()``: the same 128×128 render of the same 512 Gaussians within
2e-4 max abs, the port through its stream backend (B1's plain version
here), the JAX package through its ``jnp`` compositor on a table that
clips nothing. The JAX ``entry()``'s own table (256 entries a tile) clips
entries of this scene, which the port's ``jnp`` operator on that table
reproduces within 2e-4 (ROADMAP C15). ``dryrun_multichip`` is in
``test_torch_tools_dryrun.py``.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import torch

from mvs_gaussian_splatting_tpu.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu.ops.render import render as jrender
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
    RasterConfig as TConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render
from mvs_gaussian_splatting_tpu_torch.tools import graft_entry

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_graft():
    """The JAX repository's ``__graft_entry__.py``, with the persistent
    compile cache it turns on at import switched back off."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", cache)
    return mod


def test_entry_matches_jax():
    jfn, jargs = _jax_graft().entry()
    jimg = np.asarray(jax.jit(jfn)(*jargs))
    jparams, jalive, jcam, jbg = jargs
    fn, args = graft_entry.entry(device="cpu")
    params, alive, cam, bg = args
    # the same draws; the 3-NN scales round apart by up to 2e-6 of a value
    for k, v in params._asdict().items():
        if v is not None:
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(getattr(jparams, k)),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    img = fn(*args)
    assert img.shape == (3, 128, 128) == jimg.shape
    assert bool(torch.isfinite(img).all())
    # the JAX entry's jnp layout keeps 256 entries a 16x16 tile and clips
    # some here; the port's stream clips none: it is held to the JAX
    # renderer on a table wide enough to clip nothing
    free = RasterConfig(tile_capacity=384, max_tiles_per_gaussian=32,
                        tile_batch=32, backend="jnp")
    jout = jax.jit(lambda p, a, c, b: jrender(
        c, 128, 128, p, b, sh_degree=3, alive=a, raster_config=free))(
        *jargs)
    assert int(jout["overflow_capacity"]) == 0
    gap = float(np.abs(img.numpy() - np.asarray(jout["render"])).max())
    print(f"entry image max abs gap {gap:.2e}")
    assert gap <= 2e-4
    out = render(cam, 128, 128, params, bg, sh_degree=3, alive=alive,
                 raster_config=TConfig(backend="stream"))
    assert int(out["overflow_capacity"]) == int(out["overflow_tiles"]) == 0
    # the port's jnp operator on the JAX entry's layout clips alike
    clipped = render(cam, 128, 128, params, bg, sh_degree=3, alive=alive,
                     raster_config=TConfig(**free._replace(
                         tile_capacity=256)._asdict()))
    assert int(clipped["overflow_capacity"]) > 0
    assert float(np.abs(clipped["render"].numpy() - jimg).max()) <= 2e-4

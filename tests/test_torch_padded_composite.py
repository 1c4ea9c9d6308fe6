"""The padded composites (B4/B5's plain versions) and the padded backend's
CLI held against the JAX package (moved from ``test_torch_padded.py``,
whose helpers and bounds they use)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_padded import (jrast, TILES_X, TOL, REL, rel_gap, tables,
                               _jax_padded_vjp, _jax_padded_vjp_tiles)

from mvs_gaussian_splatting_tpu_torch.ops import composite as tcomp

torch.set_num_threads(1)


class TestPaddedComposite:
    @pytest.mark.parametrize("holes", [False, True])
    def test_plain_matches_pallas_interpret(self, holes):
        k = 128
        planes, rgb, valid, counts = tables(2, k, holes)
        t, p = counts.shape[0], 256
        bg = np.array([0.2, 0.4, 0.1], np.float32)
        rng = np.random.RandomState(3)
        g_out = rng.randn(t, p, 3).astype(np.float32)
        g_tfin = rng.randn(t, p).astype(np.float32)
        (out_j, tfin_j), (gpl_j, grgb_j, gbg_j) = _jax_padded_vjp(
            [jnp.asarray(a) for a in planes], jnp.asarray(rgb),
            jnp.asarray(valid), jnp.asarray(counts), jnp.asarray(bg), k,
            (jnp.asarray(g_out), jnp.asarray(g_tfin)))

        tp = torch.from_numpy(np.stack(planes))
        args = (tp, torch.from_numpy(rgb), torch.from_numpy(valid),
                torch.from_numpy(counts), torch.from_numpy(bg), TILES_X, 16,
                16)
        out, tfin = tcomp.composite_padded_plain(*args)
        gap = max(float(np.abs(out.numpy() - np.asarray(out_j)).max()),
                  float(np.abs(tfin.numpy() - np.asarray(tfin_j)).max()))
        gpl, grgb, gbg = tcomp.composite_padded_bwd_plain(
            *args, out, tfin, torch.from_numpy(g_out),
            torch.from_numpy(g_tfin))
        gaps = [rel_gap(gpl[r].numpy(), gpl_j[r]) for r in range(6)]
        gaps.append(rel_gap(grgb.numpy(), grgb_j))
        gaps.append(rel_gap(gbg.numpy(), gbg_j))
        print(f"holes {holes}: forward {gap:.2e}, gradients "
              + " ".join(f"{g:.1e}" for g in gaps))
        assert gap <= TOL and max(gaps) <= REL
        # padded and invalid slots: exact zeros, in the port and in JAX
        dead = valid == 0
        assert dead.any() and (~dead).any()
        assert not gpl.numpy()[:, dead].any() and not grgb.numpy()[dead].any()
        assert not np.asarray(gpl_j)[:, dead].any()
        # and the JAX package's own jnp tile compositor agrees
        out_jnp, _ = jrast.composite_tiles_jnp(
            jnp.stack(planes[:2], -1), jnp.stack(planes[2:5], -1),
            jnp.asarray(rgb), jnp.asarray(planes[5]), jnp.asarray(valid > 0),
            jnp.arange(t), TILES_X, 16, 16, jnp.asarray(bg))
        assert float(np.abs(out.numpy().transpose(0, 2, 1)
                            - np.asarray(out_jnp)).max()) <= TOL

    # 24×10 and 8×4: tiles of a part-filled and of a single 8×4 warp block,
    # which B5 takes since its redesign
    @pytest.mark.parametrize("geometry", [(24, 10), (8, 4)])
    def test_plain_bwd_matches_pallas_interpret_odd_tiles(self, geometry):
        tw, th = geometry
        k = 128
        s = tcomp.random_tables(5, tiles_x=3, tiles_y=2, tile_w=tw,
                                tile_h=th, k=k)
        t, p = s["counts"].shape[0], tw * th
        rng = np.random.RandomState(6)
        g_out = rng.randn(t, p, 3).astype(np.float32)
        g_tfin = rng.randn(t, p).astype(np.float32)
        (out_j, tfin_j), (gpl_j, grgb_j, gbg_j) = _jax_padded_vjp_tiles(
            [jnp.asarray(a) for a in s["planes"]], jnp.asarray(s["rgb"]),
            jnp.asarray(s["valid"]), jnp.asarray(s["counts"]),
            jnp.asarray(s["bg"]), (jnp.asarray(g_out), jnp.asarray(g_tfin)),
            s["tiles_x"], tw, th, k)
        args = [torch.from_numpy(s[key]) for key in
                ("planes", "rgb", "valid", "counts", "bg")] + [
            s["tiles_x"], tw, th]
        out, tfin = tcomp.composite_padded_plain(*args)
        gap = max(float(np.abs(out.numpy() - np.asarray(out_j)).max()),
                  float(np.abs(tfin.numpy() - np.asarray(tfin_j)).max()))
        gpl, grgb, gbg = tcomp.composite_padded_bwd_plain(
            *args, out, tfin, torch.from_numpy(g_out),
            torch.from_numpy(g_tfin))
        gaps = [rel_gap(gpl[r].numpy(), gpl_j[r]) for r in range(6)]
        gaps += [rel_gap(grgb.numpy(), grgb_j), rel_gap(gbg.numpy(), gbg_j)]
        print(f"{tw}x{th}: forward {gap:.2e}, gradients "
              + " ".join(f"{g:.1e}" for g in gaps))
        assert gap <= TOL and max(gaps) <= REL
        dead = s["valid"] == 0
        assert dead.any()
        assert not gpl.numpy()[:, dead].any() and not grgb.numpy()[dead].any()

"""The port's sharded compress pipeline
(``tools/sharded_compress_pipeline.py``) at a tiny size over 2 gloo ranks,
held to the five criteria of the JAX repository's
``tests/test_shard_compress_pipeline.py``: training raises the test PSNR
by more than 0.5 dB, the saved PLY renders offline within 0.2 dB of the
in-memory state, the compressed file is smaller, it costs under 3 dB and
stays above the initial PSNR. The size is cut from that test's 96×96,
1,024 slots and 40 steps to 64×64, 512 slots and 24 steps (the plain
composites on the CPU); none of the training's instances is clipped
(asserted)."""

import torch
import torch_parallel_ranks as R

from mvs_gaussian_splatting_tpu_torch.tools import sharded_compress_pipeline

torch.set_num_threads(1)


def test_pipeline_meets_the_jax_criteria(tmp_path):
    result = R.niced(
        sharded_compress_pipeline.run, str(tmp_path / "out"), n_dev=2,
        width=64, height=64, capacity=512, iters=24, num_codes=64,
        device="cpu", log=lambda *_: None).result()
    assert result["train_overflow_capacity"] == 0
    assert result["psnr_trained_loop_eval"] > result["psnr_init"] + 0.5
    assert abs(result["psnr_offline_raw_ply"]
               - result["psnr_trained_loop_eval"]) < 0.2
    assert result["compressed_npz_bytes"] < result["raw_ply_bytes"]
    assert result["compression_delta_db"] < 3.0
    assert result["psnr_offline_compressed"] > result["psnr_init"]
    assert (tmp_path / "out" / "results.json").is_file()

"""sha256 digests of the full, shared and slice-1 paths' outputs (dev
tool), so that two trees' outputs can be held equal bit for bit.

Each path is ``StereoPipeline.process_batch`` on chip_smoke.py's rendered
frames (8 x 1280x720, 128 disparities) in chip_smoke.py's configuration
for it; every output tensor is digested, and one line per path goes to
stdout with the card's name. ``--root`` takes the package and
chip_smoke.py from another checkout, such as an unpacked parent commit:

    python tools/path_digest.py
    python tools/path_digest.py --root _local/parent

It needs a CUDA card and nvcc.
"""

import argparse
import hashlib
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.pipeline import (PipelineConfig,
                                                       StereoPipeline)
    if not torch.cuda.is_available():
        raise SystemExit("path_digest: needs a CUDA card")
    B, H, W, D = chip_smoke.MAIN
    rig, lefts, rights, _ = chip_smoke.render_frames(B, H, W)
    speckle = SGBMParams(num_disparities=D, block_size=5,
                         speckle_window_size=200, speckle_range=2)
    paths = {
        "full": PipelineConfig(sgbm=speckle, downscale=1, use_wls=True,
                               lr_mode="right_matcher",
                               remap_precision="u8"),
        "shared": PipelineConfig(sgbm=speckle, downscale=1, use_wls=True,
                                 lr_mode="right_matcher",
                                 remap_precision="u8", pair_mode="shared"),
        "slice-1": PipelineConfig(
            sgbm=SGBMParams(num_disparities=D, block_size=5,
                            speckle_window_size=0),
            downscale=1, use_wls=False, lr_mode="fast",
            remap_precision="u8"),
    }
    card = torch.cuda.get_device_name(0)
    for name, cfg in paths.items():
        out = StereoPipeline(rig, cfg, rectify=True).process_batch(lefts,
                                                                   rights)
        h = hashlib.sha256()
        for key in sorted(out):
            value = out[key]
            if isinstance(value, torch.Tensor):
                h.update(key.encode())
                h.update(value.detach().cpu().contiguous().numpy().tobytes())
        print(f"path digest [{card}] {name}: {h.hexdigest()} "
              f"({', '.join(sorted(out))})", flush=True)
        del out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

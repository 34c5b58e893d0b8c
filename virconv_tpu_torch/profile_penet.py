"""PENetC2's forward on the card with and without cuDNN's deterministic
algorithms: ENet's ms (with its heads) and whether one frame's depth
repeats to the bit, within the process and against the depths an earlier
run of this module left in ``--out``.

    python3 -m virconv_tpu_torch.profile_penet --out chiprun_out
    python3 -m virconv_tpu_torch.profile_penet --out chiprun_out

One 352 x 1216 frame of a ``scene`` tree, seeded weights, f32 with TF32
off, 4 forwards per setting (the first builds cuDNN's plans). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .models.depth_completion import virtual_points as vp
from .utils.mini_kitti import write_tree


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', type=str, required=True)
    args = parser.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        split = write_tree(Path(tmp) / 'kitti', 'scene', frames=1) \
            / 'training'
        _, rgb_c, sparse, pos, k_mat, _, _, _ = vp.prepare_frame(split,
                                                                 '000000')
    gen = vp.VirtualPointGenerator(device='cuda')
    dev = gen.device

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    inputs = (dev_t(rgb_c).permute(2, 0, 1)[None].float(),
              dev_t(sparse)[None, None], dev_t(pos).permute(2, 0, 1)[None],
              dev_t(k_mat)[None])
    print(f'card "{torch.cuda.get_device_name(0)}"', flush=True)
    for det in (False, True):
        depths, ms = [], []
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, deterministic=det, allow_tf32=False):
            for _ in range(4):
                torch.cuda.synchronize()
                t = time.perf_counter()
                heads = gen.model.heads(*inputs)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
                depths.append(gen.model.propagate(heads).cpu().numpy())
        path = out / f'penet_depth_deterministic_{det}.npy'
        earlier = (f', the same bits as the depth in {path.name}: '
                   f'{np.array_equal(np.load(path), depths[0])}'
                   if path.exists() else '')
        np.save(path, depths[0])
        print(f'deterministic {det}: ENet and heads ms '
              f'{[round(x, 2) for x in ms]}; 4 forwards the same bits: '
              f'{all(np.array_equal(depths[0], d) for d in depths)}'
              f'{earlier}', flush=True)


if __name__ == '__main__':
    main()

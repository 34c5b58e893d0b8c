"""Virtual-point generation with the PyTorch port (``virconv_tpu_torch``).

The counterpart of ``tools/generate_virtual_points.py``: PENet depth
completion over a KITTI split (``image_2``, ``velodyne``, ``calib``),
written as fused real + virtual ``velodyne_depth/<frame>.npy`` files.
Runs on CUDA unless ``--device cpu`` is passed. ``--ckpt`` takes a
reference PENet_C2 checkpoint (``.pth`` / ``.pth.tar``, e.g. ``pe.pth.tar``);
without it the weights are random (seed 0).

    python tools/generate_virtual_points_gpu.py --detpath \\
        data/kitti/training [--ckpt pe.pth.tar] [--limit N]
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='PENet virtual points for a KITTI split')
    parser.add_argument('--detpath', type=str, required=True)
    parser.add_argument('--ckpt', type=str, default=None,
                        help='reference PENet_C2 checkpoint (.pth, .pth.tar)')
    parser.add_argument('--limit', type=int, default=None)
    parser.add_argument('--device', type=str, default='cuda')
    return parser.parse_args(argv)


def main(argv=None):
    """Generate the split's virtual points; returns the
    ``GenerationResult`` (frames, points per frame, seconds by stage)."""
    args = parse_args(argv)
    from virconv_tpu_torch.models.depth_completion.penet_import import \
        load_penet_checkpoint
    from virconv_tpu_torch.models.depth_completion.virtual_points import \
        VirtualPointGenerator

    root = Path(args.detpath)
    state_dict = None
    if args.ckpt:
        if not args.ckpt.endswith(('.pth', '.pth.tar')):
            raise SystemExit(f'--ckpt {args.ckpt}: expected a .pth or '
                             '.pth.tar reference checkpoint')
        state_dict = load_penet_checkpoint(args.ckpt)
    else:
        print('no --ckpt: PENet weights are random (seed 0)')
    gen = VirtualPointGenerator(state_dict, device=args.device)
    frames = sorted(p.stem for p in (root / 'velodyne').glob('*.bin'))
    if args.limit:
        frames = frames[:args.limit]
    res = gen.generate(root, frames)
    stages = ', '.join(f'{k} {v:.4f}' for k, v in res.per_frame().items())
    print(f'{len(res.frames)} frames on {res.device}; seconds per frame: '
          f'{stages}')
    return res


if __name__ == '__main__':
    main()

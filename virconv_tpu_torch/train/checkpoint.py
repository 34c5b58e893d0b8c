"""Checkpoints of the port: one ``torch.save`` file per epoch.

``checkpoint_epoch_<n>.pth`` holds ``model_state`` (the model's
``state_dict``: parameters and BN statistics), ``epoch``, and
``optimizer_state`` and ``step`` when a trainer passes them
(``Trainer.state_dict()``, which ``Trainer.load_state_dict`` takes back),
every tensor on the CPU. The newest ``max_keep`` (default ``MAX_KEEP``,
30) by modification time are kept, as ``virconv_tpu/train/trainer.py``
keeps its orbax checkpoints. ``eval_one_ckpt`` reads ``model_state``
only. A JAX checkpoint reaches the port only through
``utils/jax_weights.from_jax_variables``, run where JAX is installed.
"""

from __future__ import annotations

from pathlib import Path

import torch

PATTERN = 'checkpoint_epoch_*.pth'
MAX_KEEP = 30


def _by_age(ckpt_dir):
    """Checkpoints oldest first (mtime, then epoch)."""
    def key(p):
        return p.stat().st_mtime_ns, int(p.stem.rsplit('_', 1)[-1])
    return sorted(Path(ckpt_dir).glob(PATTERN), key=key)


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(ckpt_dir, state_dict, epoch: int, optimizer_state=None,
                    step: int | None = None, max_keep: int = MAX_KEEP):
    """Write ``checkpoint_epoch_<epoch>.pth`` and delete all but the newest
    ``max_keep``; returns the path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f'checkpoint_epoch_{epoch}.pth'
    state = {'model_state': _cpu(dict(state_dict)), 'epoch': int(epoch)}
    if optimizer_state is not None:
        state['optimizer_state'] = _cpu(optimizer_state)
    if step is not None:
        state['step'] = int(step)
    tmp = path.with_suffix('.tmp')
    torch.save(state, tmp)
    tmp.replace(path)
    for old in _by_age(ckpt_dir)[:-max_keep]:
        old.unlink()
    return path


def load_checkpoint(path):
    """The dict ``save_checkpoint`` wrote, its tensors on the CPU."""
    return torch.load(path, map_location='cpu', weights_only=True)


def latest_checkpoint(ckpt_dir):
    ckpts = _by_age(ckpt_dir)
    return ckpts[-1] if ckpts else None

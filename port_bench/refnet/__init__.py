"""The plain reference of the benchmark: VoxelRCNN (VirConv-T and
VirConv-L), its losses, the optimizer and the serving post-processing, in
plain PyTorch and numpy.

A frozen copy of the measured program's plain versions, taken when the
benchmark was written, on one route, the plainest (every sparse conv on
the neighbor map, every ROI pool on the probe path, f32 operands), and
with no kernel: later changes to the program cannot move it. It imports
nothing of the program. ``follow_keep`` and ``follow_sampled`` let it take
the measured side's NMS selection and proposals and its ROI samples
(``benchlib/judge.py`` checks those stages by themselves), so that
round-off cannot send the two down different branches.
"""

"""Inputs for the RPN's batched NMS tests (``tests/test_torch_boxes.py`` on
the CPU, ``tests/test_torch_cuda.py`` on the card): seeded proposal
clusters around the cars of a street, exact score ties, exact geometry
(identical, touching and parallel-edged boxes), small and ragged k, entries
with no valid proposal, and suppression chains longer than the fixed
point's 8 passes. Imports no JAX."""
import numpy as np

N_CARS = 25
CAR = (3.9, 1.6, 1.56)
CASES = ('train', 'serve', 'ties', 'geometry', 'k40', 'k200', 'invalid',
         'few', 'chain')


def _cars(rng):
    xy = np.stack([rng.uniform(2, 68, N_CARS), rng.uniform(-36, 36, N_CARS)],
                  -1)
    return xy, rng.uniform(-np.pi, np.pi, N_CARS)


def proposals(rng, batch, n, spread=0.3, background=0.3):
    """(batch, n, 7) boxes: most around N_CARS cars (centre jitter
    ``spread`` m, sizes +-10 %, heading +-0.1 rad, a tenth turned by pi),
    the rest anywhere; scores (batch, n) higher on the cars. Neighbours
    along a car's length have IoUs across 0.75-0.8."""
    boxes = np.zeros((batch, n, 7), np.float32)
    scores = np.zeros((batch, n), np.float32)
    for b in range(batch):
        xy, yaw = _cars(rng)
        car = rng.integers(0, N_CARS, n)
        on = rng.uniform(size=n) > background
        boxes[b, :, 0:2] = np.where(
            on[:, None], xy[car] + rng.normal(0, spread, (n, 2)),
            rng.uniform([0, -40], [70, 40], (n, 2)))
        boxes[b, :, 2] = rng.uniform(-1.2, -0.6, n)
        boxes[b, :, 3:6] = np.asarray(CAR) * rng.uniform(0.9, 1.1, (n, 3))
        boxes[b, :, 6] = np.where(on, yaw[car], rng.uniform(-np.pi, np.pi,
                                                            n))
        boxes[b, :, 6] += rng.normal(0, 0.1, n) + np.pi * (
            rng.uniform(size=n) < 0.1)
        scores[b] = np.where(on, rng.uniform(0.3, 1.0, n),
                             rng.uniform(0.0, 0.4, n))
    return boxes, scores


def _geometry(rng, batch, n):
    """Exact binary fractions: identical boxes, boxes touching along an
    edge, and boxes whose edges are parallel and collinear."""
    boxes = np.zeros((batch, n, 7), np.float32)
    for b in range(batch):
        i = np.arange(n)
        boxes[b, :, 0] = 4.0 * (i % 16) + 0.25 * rng.integers(0, 4, n)
        boxes[b, :, 1] = 2.0 * (i // 16) + 0.5 * rng.integers(0, 2, n)
        boxes[b, :, 3:6] = (4.0, 2.0, 1.5)
        boxes[b, :, 6] = np.where(rng.uniform(size=n) < 0.2, np.pi / 2, 0.0)
        boxes[b, n // 2:n // 2 + n // 8] = boxes[b, :n // 8]    # identical
    scores = rng.uniform(size=(batch, n)).astype(np.float32)
    return boxes, scores


def _chain(rng, batch, length=24):
    """Rows of boxes 0.3 m apart along x (neighbours' IoU 0.86, next but
    one 0.74), scores falling along the row: greedy NMS keeps every other
    box, 8 passes of the fixed point leave the tail unresolved."""
    boxes = np.zeros((batch, 3 * length, 7), np.float32)
    scores = np.zeros((batch, 3 * length), np.float32)
    for b in range(batch):
        for r in range(3):
            s = slice(r * length, (r + 1) * length)
            boxes[b, s, 0] = 10.0 + 0.3 * np.arange(length)
            boxes[b, s, 1] = -20.0 + 10.0 * r + 0.01 * b
            boxes[b, s, 3:6] = (4.0, 1.6, 1.5)
            boxes[b, s, 6] = rng.uniform(-0.01, 0.01)
            scores[b, s] = 0.99 - 0.01 * np.arange(length) - 0.001 * r
    return boxes, scores


def make(name, full=True, seed=0):
    """A case: dict(boxes (B, n, 7), scores (B, n), valid (n,), thresh,
    pre, post). ``full``: the main path's sizes (the card); otherwise
    sizes a CPU test runs in seconds."""
    rng = np.random.default_rng([seed, CASES.index(name)])
    thresh, pre, post = 0.8, 4000, 512
    if name == 'train':
        b, n = (6, 70400) if full else (3, 600)
        pre, post = (4000, 512) if full else (300, 64)
        boxes, scores = proposals(rng, b, n)
    elif name == 'serve':
        b, n = (2, 70400) if full else (2, 500)
        thresh, pre, post = 0.75, 2000 if full else 200, 50
        boxes, scores = proposals(rng, b, n)
    elif name == 'ties':
        b, n = (2, 3000) if full else (2, 400)
        pre, post = (1000, 200) if full else (250, 60)
        boxes, scores = proposals(rng, b, n, spread=0.2)
        scores = np.round(scores * 16) / 16          # exact ties
    elif name == 'geometry':
        b, n, pre, post = 2, 256, 256, 100
        thresh = 0.3
        boxes, scores = _geometry(rng, b, n)
    elif name == 'k40':
        b, n, post = 3, 40, 16
        boxes, scores = proposals(rng, b, n, spread=0.1, background=0.0)
    elif name == 'k200':
        b, n, pre, post = 2, 300, 200, 64
        thresh = 0.75
        boxes, scores = proposals(rng, b, n, spread=0.2, background=0.0)
    elif name == 'invalid':
        b, n, pre, post = 2, 500, 200, 50
        boxes, scores = proposals(rng, b, n)
    elif name == 'few':
        b, n, post = 2, 30, 50
        boxes, scores = proposals(rng, b, n, spread=0.1, background=0.0)
    else:
        b = 2
        boxes, scores = _chain(rng, b)
        n, post = boxes.shape[1], 40
    valid = rng.uniform(size=n) > 0.3
    if name == 'invalid':
        valid[:] = False
    elif name in ('geometry', 'chain'):
        valid[:] = True
    return dict(boxes=boxes, scores=scores.astype(np.float32), valid=valid,
                thresh=thresh, pre=pre, post=post)

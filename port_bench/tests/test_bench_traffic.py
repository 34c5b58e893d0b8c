"""The traffic generator: one seed gives the same items, another seed or
another item gives other points."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH
from benchlib.traffic import Traffic

DATA = os.path.join(BENCH, 'tests', 'data')


def cfg(name):
    return json.load(open(os.path.join(DATA, name + '.json')))['config']


def traffic(mode):
    return json.load(open(os.path.join(DATA, 'traffic', f'tiny_{mode}.json')))


def same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a if a[k] is not None)


@pytest.mark.parametrize('mode', ['infer', 'train'])
@pytest.mark.parametrize('config', ['tiny_t', 'tiny_l'])
def test_seeded(mode, config):
    big = 2 ** 31 + 12345
    t1 = Traffic(traffic(mode), cfg(config), big)
    t2 = Traffic(traffic(mode), cfg(config), big)
    t3 = Traffic(traffic(mode), cfg(config), big + 1)
    a, b = t1.item(0), t2.item(0)
    assert same(a, b)
    assert not np.array_equal(a['points'], t1.item(1)['points'])
    assert not np.array_equal(a['points'], t3.item(0)['points'])
    assert t1.size(0) == t2.size(0)
    n = a['points_valid'].sum(1)
    assert (n > 0).all()


def test_shapes():
    t = Traffic(traffic('infer'), cfg('tiny_t'), 3)
    f = t.item(0)
    assert f['points'].shape == (2, 2048, 8)
    assert f['points_mm'].shape == (2, 4096, 8)
    b = Traffic(traffic('train'), cfg('tiny_t'), 3).item(0)
    # 2 frames x the ROI head's ROT_NUM replicas
    assert b['points'].shape[0] == 2 * cfg('tiny_t')['MODEL']['ROI_HEAD'][
        'ROT_NUM']
    bl = Traffic(traffic('train'), cfg('tiny_l'), 3).item(0)
    assert bl['points'].shape[0] == 2 and 'points_mm' not in bl

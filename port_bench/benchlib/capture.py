"""Forward hooks (public ``nn.Module`` hooks, no patch) on a VoxelRCNN,
the program's or the reference's, that keep what one forward produced
while ``armed``: the RPN's three conv maps, its NMS selection and
proposals, the ROI sampling of each stage (training), the query points
and pooled features of every ROI grid pool call (every stage's), the
class and box-residual outputs of every stage of the ROI head, and the
model's outputs. On the program, ``branches`` (its public pool branch
counter) marks each pool call with the branch it took. ``follow_pools``
makes a model pool at another model's query points."""

from __future__ import annotations


class Capture:
    """``keep_feats`` False (training) keeps no feature tensors: the BEV
    map, the pooled features and the stage outputs."""

    def __init__(self, model, keep_feats=True, branches=None):
        self.armed = False
        self.items = []
        self._cur = {}
        self.keep_feats = keep_feats
        self.branches = branches
        self._kernel_calls = 0
        head = model.dense_head
        roi = model.roi_head
        self.handles = [
            head.conv_cls.register_forward_hook(self._map('cls_map')),
            head.conv_box.register_forward_hook(self._map('box_map')),
            head.conv_dir.register_forward_hook(self._map('dir_map')),
            head.register_forward_hook(self._rpn),
            roi.register_forward_hook(self._roi),
            roi.cls_head.register_forward_hook(self._stage('stage_cls')),
            roi.reg_head.register_forward_hook(self._stage('stage_reg')),
            model.register_forward_hook(self._out)]
        for name, mod in pool_modules(model):
            self.handles.append(mod.register_forward_pre_hook(
                self._pool(name)))
            self.handles.append(mod.register_forward_hook(self._pooled))

    def _kernel_count(self):
        return self.branches.get('kernel', 0)

    def _pooled(self, module, args, output):
        if not self.armed:
            return
        if self.keep_feats:
            self._cur.setdefault('pooled', []).append(output.detach())
        if self.branches is not None:
            ran = self._kernel_count() > self._kernel_calls
            self._cur.setdefault('pool_branch', []).append(
                'kernel' if ran else 'probe')

    def _pool(self, name):
        def hook(module, args):
            if self.armed:
                self._cur.setdefault('pool_q', []).append(
                    (name, args[2].detach(), args[3], args[4]))
                if self.branches is not None:
                    self._kernel_calls = self._kernel_count()
        return hook

    def _stage(self, name):
        # the main branch's heads run once a stage at eval (training adds
        # the two single-stream branches' own modules)
        def hook(module, inputs, output):
            if self.armed and self.keep_feats:
                self._cur.setdefault(name, []).append(output.detach())
        return hook

    def _map(self, name):
        def hook(module, inputs, output):
            if self.armed:
                self._cur[name] = output.detach()
        return hook

    def _rpn(self, module, inputs, out):
        if self.armed:
            self._cur['keep'] = out['keep'].detach()
            self._cur['keep_valid'] = out['roi_valid'].detach()
            self._cur['rois'] = out['rois'].detach()

    def _roi(self, module, inputs, out):
        if self.armed and 'stage_targets' in out:
            self._cur['sampled'] = [(s['targets']['sampled'].detach(),
                                     s['targets']['rois'].detach())
                                    for s in out['stage_targets']]

    def _out(self, module, inputs, out):
        if not self.armed:
            return
        cur, self._cur = self._cur, {}
        if self.keep_feats:
            cur['bev'] = out['bev_feats'].detach()
        cur['cls'] = out['batch_cls_preds'].detach()
        cur['box'] = out['batch_box_preds'].detach()
        cur['roi_valid'] = out['roi_valid'].detach()
        self.items.append(cur)

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def pool_modules(model):
    """The ROI head's grid pools (``pool_<source>``, ``pool_mm_<source>``)
    by name."""
    return [(n, m) for n, m in model.roi_head.named_children()
            if n.startswith('pool')]


def follow_pools(model, calls, own=None):
    """Pre-hooks that make ``model``'s grid pools take, call by call, the
    query points, voxel coordinates and mask of ``calls`` (another model's
    ``pool_q``). The points keep the model's own gradient path: its own
    points plus the detached difference. When ``own`` is a list, each
    call appends the model's own query points and the other's, with the
    other's query mask, so that the points themselves can be compared.
    Returns the handles."""
    calls = list(calls)

    def make(name):
        def hook(module, args):
            other, xyz, coords, mask = calls.pop(0)
            if other != name or xyz.shape != args[2].shape:
                raise ValueError(f'pool call {name} {tuple(args[2].shape)} '
                                 f'against {other} {tuple(xyz.shape)}')
            mine = args[2]
            if own is not None:
                own.append((mine.detach(), xyz, mask))
            return (args[0], args[1], mine + (xyz - mine).detach(), coords,
                    mask) + tuple(args[5:])
        return hook
    return [m.register_forward_pre_hook(make(n))
            for n, m in pool_modules(model)]

"""Host ms per frame inside the program's ``vp.depth2points`` span (the
host tail on the generator's worker threads: back-projection,
``fuse_virtual_and_lidar``, ``la_sampling2``), from the program's tracing
registry."""


def read(s):
    if s['mode'] != 'vp' or not s.get('snapshot'):
        return None
    span = s['snapshot']['spans'].get('vp.depth2points')
    if not span or not span['calls']:
        return None
    return 1e3 * span['host_s'] / span['calls']

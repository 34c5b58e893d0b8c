"""Host syncs per frame in the profiled stretch: CUDA's synchronizing
operations counted by the program's tracing module under its spans (the
uploads and the depth's download under ``vp.copy``), over the frames whose
forwards ran in it (``penet.enet`` calls)."""


def read(s):
    snap = s.get('snapshot') if s['mode'] == 'vp' else None
    if not snap or not snap['spans'].get('penet.enet', {}).get('calls'):
        return None
    return sum(e['syncs'] for e in snap['spans'].values()) \
        / snap['spans']['penet.enet']['calls']

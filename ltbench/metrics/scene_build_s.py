"""Host clock, with a synchronize, around the program's scene build:
``TriangleMesh.build``, ``MaterialTable.build``, ``Scene.build`` and
``with_bvh`` (the tree, its records and, where attached, the treelet
tables)."""


def read(record):
    return record["scene_build_s"]

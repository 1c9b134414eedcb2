"""Surface triangulations: unit sphere, red blood cells, mesh IO.

Counterpart of examples/BEM/Triangulation.hpp (octahedron subdivision
:104-135, RBC profile :184-257, random multi-cell grids :260-322) in
vectorised numpy: a triangulation is an array [n, 3, 3] of vertex
triples (panel i, vertex j, coordinate k).
"""

from __future__ import annotations

import numpy as np

_OCT_VERTS = np.array(
    [
        [1.0, 0, 0],
        [-1.0, 0, 0],
        [0, 1.0, 0],
        [0, -1.0, 0],
        [0, 0, 1.0],
        [0, 0, -1.0],
    ]
)
_OCT_FACES = np.array(
    [[0, 4, 2], [2, 4, 1], [1, 4, 3], [3, 4, 0], [0, 2, 5], [2, 1, 5], [1, 3, 5], [3, 0, 5]]
)


def _subdivide(tris):
    """4-way split with new midpoints projected to the unit sphere
    (ref triangle::split, Triangulation.hpp:36-54)."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    a = 0.5 * (v0 + v2)
    b = 0.5 * (v0 + v1)
    c = 0.5 * (v1 + v2)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    out = np.stack(
        [
            np.stack([v0, b, a], axis=1),
            np.stack([b, v1, c], axis=1),
            np.stack([a, b, c], axis=1),
            np.stack([a, c, v2], axis=1),
        ],
        axis=1,
    )
    return out.reshape(-1, 3, 3)


def unit_sphere(recursions: int = 2) -> np.ndarray:
    """Octahedron-based unit-sphere triangulation: 8 * 4^(rec-1) panels
    (rec=4 -> 512, the LaplaceBEM default operating point)."""
    tris = _OCT_VERTS[_OCT_FACES]
    for _ in range(max(0, recursions - 1)):
        tris = _subdivide(tris)
    return tris


def _rbc_map(v):
    """Map unit-sphere vertices to the erythrocyte biconcave profile
    (ref ConvertRedBloodCellTriangle, Triangulation.hpp:186-208)."""
    r, C0, C2, C4 = 3.91, 0.81, 7.83, -4.39
    x = v[..., 0] * r
    y = v[..., 1] * r
    ratio2 = (x * x + y * y) / (r * r)
    z = (
        np.sqrt(np.maximum(1 - ratio2, 0.0) + 1e-12)
        * (C0 + C2 * ratio2 + C4 * ratio2 * ratio2)
        * 0.5
        * np.sign(v[..., 2])
    )
    return np.stack([x, y, z], axis=-1)


def red_blood_cell(recursions=2, rotation=None, shift=(0.0, 0.0, 0.0)):
    """One RBC triangulation, optionally rotated and shifted."""
    tris = unit_sphere(recursions)
    tris = _rbc_map(tris)
    if rotation is not None:
        tris = tris @ np.asarray(rotation).T
    return tris + np.asarray(shift)[None, None, :]


def _random_rotation(rng):
    """Uniform random rotation matrix (QR of a Gaussian)."""
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    return q * np.sign(np.diag(r))


def multiple_red_blood_cells(cells=2, recursions=2, spacing=10.0, seed=0):
    """Grid of randomly oriented RBCs (ref MultipleRedBloodCell,
    Triangulation.hpp:260-322)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(cells ** (1.0 / 3.0)))
    tris = []
    n = 0
    for i in range(side):
        for j in range(side):
            for k in range(side):
                if n >= cells:
                    break
                shift = (i * spacing, j * spacing, k * spacing)
                tris.append(
                    red_blood_cell(recursions, _random_rotation(rng), shift)
                )
                n += 1
    return np.concatenate(tris, axis=0)


# ---------------------------------------------------------------------------
# mesh IO (ref MshReader.hpp, VertFaceReader.hpp, MeshIO.hpp)


def save_vert_face(tris, vert_path, face_path):
    """Write flat .vert/.face files (1-indexed, one vertex triple per
    panel — the reference's simple dump format, Triangulation.hpp:124-135)."""
    n = len(tris)
    verts = tris.reshape(n * 3, 3)
    with open(vert_path, "w") as f:
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
    with open(face_path, "w") as f:
        for i in range(n):
            f.write(f"{3*i+1} {3*i+2} {3*i+3}\n")


def _read_table(path, dtype):
    """Whitespace table reader tolerating an optional single-integer
    count header (ref VertFaceReader.hpp:33-36 expects one; the plain
    Triangulation.hpp:124-135 dump has none) and trailing extra columns
    of non-uniform width."""
    rows = []
    ncol = None
    with open(path) as f:
        first = True
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if first and len(parts) == 1:
                first = False
                continue  # count header; the row data defines the size
            first = False
            if ncol is None:
                ncol = len(parts)
            rows.append([dtype(x) for x in parts[: min(ncol, len(parts))]])
    width = min(len(r) for r in rows) if rows else 0
    return np.array([r[:width] for r in rows], dtype=dtype)


def load_vert_face(vert_path, face_path, bio=False):
    """Read .vert/.face files into a [n, 3, 3] triangulation
    (ref VertFaceReader.hpp; ``bio=True`` applies BioMeshReader.hpp's
    conventions: extra ``.vert`` columns ignored and the face file's
    columns read as ``v1 v3 v2`` — the middle column is the panel's
    THIRD vertex, BioMeshReader.hpp:30,40-43)."""
    verts = _read_table(vert_path, float)[:, :3]
    faces = _read_table(face_path, int)[:, :3] - 1
    if bio:
        faces = faces[:, [0, 2, 1]]
    return verts[faces]


def load_bio_mesh(vert_path, face_path):
    """Biomolecular-mesh reader (ref BioMeshReader.hpp): ``.vert`` rows
    carry extra columns past x y z, and the ``.face`` winding is
    ``v1 v3 v2``."""
    return load_vert_face(vert_path, face_path, bio=True)


def load_msh(path):
    """Minimal gmsh v2 ASCII reader for triangle elements
    (ref MshReader.hpp: $Nodes / $Elements sections, type-2 elements)."""
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    nodes = {}
    tris = []
    while i < len(lines):
        line = lines[i].strip()
        if line == "$Nodes":
            count = int(lines[i + 1])
            for j in range(count):
                parts = lines[i + 2 + j].split()
                nodes[int(parts[0])] = [float(x) for x in parts[1:4]]
            i += count + 2
        elif line == "$Elements":
            count = int(lines[i + 1])
            for j in range(count):
                parts = lines[i + 2 + j].split()
                etype = int(parts[1])
                if etype == 2:  # 3-node triangle
                    ntags = int(parts[2])
                    ids = [int(x) for x in parts[3 + ntags : 6 + ntags]]
                    tris.append([nodes[k] for k in ids])
            i += count + 2
        else:
            i += 1
    return np.asarray(tris, dtype=np.float64)

"""Minimal PLY reader/writer (ascii + binary_little_endian), from scratch.

Replaces the reference's vendored 916-line plyfile module
(reference utils/plyfile.py) for the subset the pipeline uses: vertex
element IO (reference utils/pc_util.py:77-95, data_prep_util.py:15-20,
119-131). Vertices round-trip through structured numpy arrays.

The port's own copy of ``alignnet3d_tpu/utils/ply.py``.
"""

from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


def read_ply(filename: str) -> dict[str, np.ndarray]:
    """Read a PLY file -> {element_name: structured array}. List properties
    (e.g. face vertex_indices) are returned as object arrays of int lists."""
    with open(filename, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    assert header_end >= 0, "not a PLY file (no end_header)"
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    assert header[0].strip() == "ply", "not a PLY file"
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype | ('list', ct, t))])
    for line in header[1:]:
        parts = line.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], ("list", _PLY_TO_NP[parts[2]],
                                _PLY_TO_NP[parts[3]]))
                )
            else:
                elements[-1][2].append((parts[2], _PLY_TO_NP[parts[1]]))
    assert fmt in ("ascii", "binary_little_endian"), fmt

    out = {}
    if fmt == "ascii":
        lines = body.decode("ascii").split("\n")
        cursor = 0
        for name, count, props in elements:
            has_list = any(isinstance(t, tuple) for _, t in props)
            if has_list:
                rows = []
                for i in range(count):
                    vals = lines[cursor + i].split()
                    j = 0
                    row = []
                    for pname, t in props:
                        if isinstance(t, tuple):
                            n = int(vals[j]); j += 1
                            row.append([int(v) for v in vals[j: j + n]])
                            j += n
                        else:
                            row.append(float(vals[j])); j += 1
                    rows.append(row)
                arr = np.empty(count, dtype=object)
                for i, r in enumerate(rows):
                    arr[i] = r[0] if len(props) == 1 else r
                out[name] = arr
            else:
                dtype = np.dtype([(p, "f8" if t.startswith("f") else "i8")
                                  for p, t in props])
                arr = np.empty(count, dtype=dtype)
                for i in range(count):
                    vals = lines[cursor + i].split()
                    for (pname, t), v in zip(props, vals):
                        arr[i][pname] = float(v)
                out[name] = arr
            cursor += count
    else:  # binary_little_endian
        offset = 0
        for name, count, props in elements:
            has_list = any(isinstance(t, tuple) for _, t in props)
            if has_list:
                arr = np.empty(count, dtype=object)
                for i in range(count):
                    row = []
                    for pname, t in props:
                        if isinstance(t, tuple):
                            _, ct, it = t
                            n = int(np.frombuffer(body, np.dtype("<" + ct),
                                                  1, offset)[0])
                            offset += np.dtype(ct).itemsize
                            vals = np.frombuffer(body, np.dtype("<" + it), n,
                                                 offset)
                            offset += n * np.dtype(it).itemsize
                            row.append(vals.tolist())
                        else:
                            v = np.frombuffer(body, np.dtype("<" + t), 1,
                                              offset)[0]
                            offset += np.dtype(t).itemsize
                            row.append(v)
                    arr[i] = row[0] if len(props) == 1 else row
                out[name] = arr
            else:
                dtype = np.dtype([(p, "<" + t) for p, t in props])
                arr = np.frombuffer(body, dtype, count, offset).copy()
                offset += dtype.itemsize * count
                out[name] = arr
    return out


def read_ply_xyz(filename: str) -> np.ndarray:
    """(N, 3) xyz of the vertex element (reference pc_util.read_ply)."""
    vertex = read_ply(filename)["vertex"]
    return np.stack(
        [vertex["x"], vertex["y"], vertex["z"]], axis=-1
    ).astype(np.float64)


def write_ply(points: np.ndarray, filename: str, text: bool = True,
              extra_props: dict | None = None):
    """Write (N, 3) xyz points (+optional same-length extra properties) as
    a PLY vertex element (reference pc_util.write_ply,
    data_prep_util.export_ply)."""
    points = np.asarray(points)
    n = len(points)
    props = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    extras = extra_props or {}
    for name, vals in extras.items():
        props.append((name, np.asarray(vals).dtype.type))
    dtype = np.dtype([(p, np.dtype(t).str.lstrip("<>=")) for p, t in props])
    arr = np.empty(n, dtype=dtype)
    arr["x"], arr["y"], arr["z"] = (
        points[:, 0].astype(np.float32),
        points[:, 1].astype(np.float32),
        points[:, 2].astype(np.float32),
    )
    for name, vals in extras.items():
        arr[name] = vals

    header = ["ply"]
    header.append(
        "format ascii 1.0" if text else "format binary_little_endian 1.0"
    )
    header.append(f"element vertex {n}")
    for pname in arr.dtype.names:
        ply_t = _NP_TO_PLY[arr.dtype[pname].name]
        header.append(f"property {ply_t} {pname}")
    header.append("end_header")

    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if text:
            for row in arr:
                f.write(
                    (" ".join(repr(float(row[p])) if "f" in
                              arr.dtype[p].kind else str(int(row[p]))
                              for p in arr.dtype.names) + "\n").encode("ascii")
                )
        else:
            f.write(arr.astype(arr.dtype.newbyteorder("<")).tobytes())

"""PCL .pcd map file interop — counterpart of slam_tpu/utils/pcd.py
(`save_pcd`, `load_pcd`, the LZF decoder).

The reference saves its aggregated map with savePCDFileASCII and loads
prior maps with loadPCDFile; its point type is plain XYZ or PointXYZGD
(xyz plus `ground_adj` / `drivable` uint16 flags). Here:

  - ASCII, `binary` and `binary_compressed` DATA encodings (the last is
    PCL's LZF-compressed field-major layout, decoded by _lzf_decompress);
  - FIELDS x y z [ground_adj] [drivable]: the flags round-trip to
    PointCloud.FLAG_GA / FLAG_DRIVABLE; unknown fields are skipped;
  - the port's clouds are batched over robots, so a save writes one
    robot's valid points (`robot`) and a load returns a cloud of batch 1
    with `capacity` slots, on the card unless `device` says otherwise.

Host-side numpy I/O with slam_tpu's header and number formats, so a file
written by either package reads the same in both.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.types import PointCloud

_TYPE_MAP = {("F", 4): "<f4", ("F", 8): "<f8",
             ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4",
             ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4"}


def _lzf_decompress(src: bytes, out_len: int) -> bytes:
    """libLZF decompression (the codec PCL's binary_compressed uses,
    pcl/io/lzf.cpp): control byte < 32 = literal run of ctrl+1 bytes,
    otherwise a back-reference of (ctrl >> 5) + 2 bytes (+ extension byte
    when the 3-bit length saturates) at offset ((ctrl & 31) << 8) + next + 1
    behind the write head; overlapping copies are byte-serial."""
    out = bytearray(out_len)
    i, o, n = 0, 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:                        # literal run
            run = ctrl + 1
            out[o:o + run] = src[i:i + run]
            i += run
            o += run
        else:                                # back reference
            length = ctrl >> 5
            if length == 7:
                length += src[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - src[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("corrupt lzf stream: reference before "
                                 "output start")
            for _ in range(length + 2):      # may overlap the write head
                out[o] = out[ref]
                o += 1
                ref += 1
    if o != out_len:
        raise ValueError(f"corrupt lzf stream: produced {o} of {out_len} "
                         "bytes")
    return bytes(out)


def save_pcd(path: str, cloud: PointCloud, with_flags: bool = True,
             binary: bool = False, robot: int = 0) -> int:
    """Write robot `robot`'s valid points of a (B, N) cloud as a .pcd
    file; returns the count.

    with_flags=True writes the PointXYZGD layout (x y z ground_adj
    drivable, flags as uint16); False writes plain xyz. binary=False
    matches the reference's savePCDFileASCII call.
    """
    if cloud.xyz.dim() != 3:
        raise ValueError("save_pcd takes a (B, N, 3) cloud; got xyz shape "
                         f"{tuple(cloud.xyz.shape)}")
    xyz = cloud.xyz[robot].detach().cpu().numpy().astype(np.float32)
    valid = cloud.valid[robot].detach().cpu().numpy().astype(bool)
    flags = cloud.flags[robot].detach().cpu().numpy().astype(np.int32)
    xyz, flags = xyz[valid], flags[valid]
    n = xyz.shape[0]
    ga = ((flags & PointCloud.FLAG_GA) != 0).astype(np.uint16)
    drv = ((flags & PointCloud.FLAG_DRIVABLE) != 0).astype(np.uint16)

    if with_flags:
        fields, sizes, types = "x y z ground_adj drivable", "4 4 4 2 2", \
            "F F F U U"
        rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                 ("ground_adj", "<u2"), ("drivable", "<u2")])
        rec["ground_adj"], rec["drivable"] = ga, drv
    else:
        fields, sizes, types = "x y z", "4 4 4", "F F F"
        rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    count = " ".join("1" for _ in fields.split())
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {count}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(rec.tobytes())
        else:
            cols = [("%.6f" if t == "F" else "%d") for t in types.split()]
            for row in rec:
                f.write((" ".join(c % v for c, v in zip(cols, row)) + "\n")
                        .encode())
    return n


def load_pcd(path: str, capacity: int | None = None,
             device=None) -> PointCloud:
    """Read a .pcd file into a fixed-capacity PointCloud of batch 1.

    Requires x/y/z fields; ground_adj/drivable (the PointXYZGD flags) map
    to FLAG_GA/FLAG_DRIVABLE when present, other fields are ignored.
    capacity=None sizes the container to the file's point count; otherwise
    the first `capacity` points are kept / missing slots are invalid.
    """
    device = default_device(device)
    with open(path, "rb") as f:
        hdr: dict[str, list[str]] = {}
        while True:
            raw_line = f.readline()
            if not raw_line:       # EOF before DATA: empty/truncated/non-pcd
                raise ValueError(
                    f"truncated pcd header (no DATA line): {path}")
            line = raw_line.decode("ascii", "replace").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            hdr[key.upper()] = vals
            if key.upper() == "DATA":
                break
        for req in ("FIELDS", "SIZE", "TYPE", "POINTS", "DATA"):
            if req not in hdr:
                raise ValueError(f"pcd header missing {req}: {path}")
        counts = [int(c) for c in
                  hdr.get("COUNT", ["1"] * len(hdr["FIELDS"]))]
        n = int(hdr["POINTS"][0])
        data = hdr["DATA"][0].lower()
        # (name, base dtype, count) per header field; PCL's '_' padding
        # fields (common in binary PointXYZI etc.) get unique throwaway
        # names so the record dtype stays valid
        specs = []
        for i, (name, s, t, cnt) in enumerate(
                zip(hdr["FIELDS"], hdr["SIZE"], hdr["TYPE"], counts)):
            if name == "_" or any(name == nm for nm, _, _ in specs):
                name = f"_pad{i}"
            specs.append((name, np.dtype(_TYPE_MAP[(t.upper(), int(s))]),
                          cnt))
        dtype = np.dtype([(f"{nm}{k}" if c > 1 else nm, dt)
                          for nm, dt, c in specs for k in range(c)])
        if data == "ascii":
            rec = np.zeros(n, dtype)
            if n > 0:
                cols = np.loadtxt(f, dtype=np.float64, ndmin=2)[:n]
                for i, name in enumerate(dtype.names):
                    rec[name] = cols[:, i]
        elif data == "binary":
            rec = np.frombuffer(f.read(n * dtype.itemsize), dtype, count=n)
        elif data == "binary_compressed":
            # PCL layout (pcl/io/pcd_io.cpp): u32 compressed size, u32
            # uncompressed size, LZF payload holding the data FIELD-MAJOR —
            # one contiguous block per header field, each block n points of
            # `count` adjacent values (not per-point records)
            comp_len, raw_len = np.frombuffer(f.read(8), "<u4")
            raw = _lzf_decompress(f.read(int(comp_len)), int(raw_len))
            rec = np.zeros(n, dtype)
            off = 0
            for nm, dt, c in specs:
                blk = np.frombuffer(raw, dt, count=n * c, offset=off)
                if c == 1:
                    rec[nm] = blk
                else:
                    blk = blk.reshape(n, c)
                    for k in range(c):
                        rec[f"{nm}{k}"] = blk[:, k]
                off += n * c * dt.itemsize
        else:
            raise ValueError(
                f"unsupported pcd DATA encoding '{data}': {path}")

    for axis in ("x", "y", "z"):
        if axis not in (rec.dtype.names or ()):
            raise ValueError(f"pcd file has no '{axis}' field: {path}")
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    # PCL writes invalid points as NaN rows (organized clouds)
    good = np.isfinite(xyz).all(-1)
    flags = np.zeros(n, np.int32)
    if "ground_adj" in rec.dtype.names:
        flags |= (rec["ground_adj"].astype(np.int32) != 0) * \
            PointCloud.FLAG_GA
    if "drivable" in rec.dtype.names:
        flags |= (rec["drivable"].astype(np.int32) != 0) * \
            PointCloud.FLAG_DRIVABLE
    xyz = np.where(good[:, None], np.nan_to_num(xyz), 0.0)

    cap = n if capacity is None else capacity
    out_xyz = np.zeros((cap, 3), np.float32)
    out_valid = np.zeros(cap, bool)
    out_flags = np.zeros(cap, np.int32)
    m = min(cap, n)
    out_xyz[:m], out_valid[:m], out_flags[:m] = xyz[:m], good[:m], flags[:m]
    return PointCloud(xyz=torch.from_numpy(out_xyz)[None].to(device),
                      valid=torch.from_numpy(out_valid)[None].to(device),
                      flags=torch.from_numpy(out_flags)[None].to(device))

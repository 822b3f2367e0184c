"""SfM data model: OpenMVG JSON <-> packed arrays.

Replaces the reference's rapidjson `OpenMvgParser` + `SfMData` of ragged
C++ vectors (reference: external/manifoldReconstructor/src/OpenMvgParser.cpp:82-250,
external/manifoldReconstructor/include/manifoldReconstructor/SfMData.h:17-31)
and the writer (reference: src/edgegraph3d/io/output/output_sfm_data.cpp:186-229).

Host side keeps ragged observation lists (numpy); `pack_observations`
produces the fixed-shape padded tensors every device kernel consumes.

Conventions (OpenMVG pinhole):
    x_hom = K (R X + t),  t = -R C,  P = K [R | t]   (3x4)
Observation keys in the JSON are pose ids; they are mapped to camera
indices by view order, mirroring OpenMvgParser.cpp:268-296 (`map_pos`).
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field, replace
from typing import Any, Sequence

import numpy as np


@dataclass
class SfMData:
    """Host-side scene: cameras, 3D points, ragged observations."""

    K: np.ndarray              # [C,3,3] float64
    R: np.ndarray              # [C,3,3] float64, world->cam rotation
    t: np.ndarray              # [C,3]   float64, t = -R @ center
    center: np.ndarray         # [C,3]   float64 camera centers
    widths: np.ndarray         # [C] int
    heights: np.ndarray        # [C] int
    image_paths: list          # [C] str (local_path + filename)
    points: np.ndarray         # [P,3] float64
    obs_cam: list              # P x int32[k_i]  camera indices per point
    obs_xy: list               # P x float64[k_i,2] 2D observations
    raw_doc: Any = None        # original parsed JSON (views/intrinsics verbatim)

    # ------------------------------------------------------------------
    @property
    def n_cameras(self) -> int:
        return int(self.K.shape[0])

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def P(self) -> np.ndarray:
        """Projection matrices K [R|t], shape [C,3,4]."""
        Rt = np.concatenate([self.R, self.t[:, :, None]], axis=2)
        return np.einsum("cij,cjk->cik", self.K, Rt)

    def points_visible_from_cam(self) -> list:
        """Reverse index: per-camera list of visible point ids
        (mirrors SfMData.h pointsVisibleFromCamN_)."""
        out = [[] for _ in range(self.n_cameras)]
        for pid, cams in enumerate(self.obs_cam):
            for c in cams:
                out[int(c)].append(pid)
        return [np.asarray(v, dtype=np.int32) for v in out]

    def copy(self) -> "SfMData":
        return SfMData(
            K=self.K.copy(), R=self.R.copy(), t=self.t.copy(),
            center=self.center.copy(), widths=self.widths.copy(),
            heights=self.heights.copy(), image_paths=list(self.image_paths),
            points=self.points.copy(),
            obs_cam=[np.asarray(a).copy() for a in self.obs_cam],
            obs_xy=[np.asarray(a).copy() for a in self.obs_xy],
            raw_doc=self.raw_doc,
        )


@dataclass
class PackedObservations:
    """Fixed-shape observation tensors for device kernels."""

    cam_idx: np.ndarray   # [P, O] int32, -1 where padded
    xy: np.ndarray        # [P, O, 2] dtype
    mask: np.ndarray      # [P, O] bool

    @property
    def n_points(self) -> int:
        return int(self.cam_idx.shape[0])


def pack_observations(
    obs_cam: Sequence[np.ndarray],
    obs_xy: Sequence[np.ndarray],
    max_obs: int | None = None,
    dtype=np.float32,
) -> PackedObservations:
    """Pad ragged per-point observation lists to [P, O] tensors."""
    n = len(obs_cam)
    widest = max((len(c) for c in obs_cam), default=0)
    O = int(max_obs) if max_obs is not None else max(widest, 1)
    cam = np.full((n, O), -1, dtype=np.int32)
    xy = np.zeros((n, O, 2), dtype=dtype)
    for i, (c, p) in enumerate(zip(obs_cam, obs_xy)):
        k = min(len(c), O)
        if k:
            cam[i, :k] = np.asarray(c[:k], dtype=np.int32)
            xy[i, :k] = np.asarray(p[:k], dtype=dtype)
    return PackedObservations(cam_idx=cam, xy=xy, mask=cam >= 0)


# ----------------------------------------------------------------------
# JSON reading (OpenMVG "sfm_data" schema)
# ----------------------------------------------------------------------

def read_sfm_data(path: str) -> SfMData:
    """Parse an OpenMVG sfm_data JSON file.

    Mirrors OpenMvgParser::parse (OpenMvgParser.cpp:68-80): intrinsics and
    extrinsics maps are keyed, views resolve them by id, observation keys
    are pose ids resolved through extrinsics order.
    """
    with open(path, "r") as f:
        doc = json.load(f)
    return sfm_data_from_doc(doc)


def sfm_data_from_doc(doc: dict) -> SfMData:
    intr = {}
    for item in doc.get("intrinsics", []):
        d = item["value"]["ptr_wrapper"]["data"]
        f = float(d["focal_length"])
        cx, cy = (float(v) for v in d["principal_point"])
        K = np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]])
        intr[int(item["key"])] = K

    extr = {}
    pose_pos = {}   # pose id -> index in extrinsics array (OpenMvgParser map_pos)
    for i, item in enumerate(doc.get("extrinsics", [])):
        key = int(item["key"])
        R = np.asarray(item["value"]["rotation"], dtype=np.float64)
        C = np.asarray(item["value"]["center"], dtype=np.float64)
        extr[key] = (R, C)
        pose_pos[key] = i

    views = doc.get("views", [])
    n_cam = len(views)
    Ks = np.zeros((n_cam, 3, 3))
    Rs = np.tile(np.eye(3), (n_cam, 1, 1))
    centers = np.zeros((n_cam, 3))
    widths = np.zeros(n_cam, dtype=np.int64)
    heights = np.zeros(n_cam, dtype=np.int64)
    paths = []
    for i, v in enumerate(views):
        d = v["value"]["ptr_wrapper"]["data"]
        paths.append(str(d.get("local_path", "")) + str(d["filename"]))
        widths[i] = int(d["width"])
        heights[i] = int(d["height"])
        Ks[i] = intr[int(d["id_intrinsic"])]
        R, C = extr[int(d["id_pose"])]
        Rs[i] = R
        centers[i] = C
    ts = -np.einsum("cij,cj->ci", Rs, centers)

    structure = doc.get("structure", [])
    pts = np.zeros((len(structure), 3))
    obs_cam, obs_xy = [], []
    for i, item in enumerate(structure):
        val = item["value"]
        pts[i] = np.asarray(val["X"], dtype=np.float64)
        cams, xys = [], []
        for ob in val.get("observations", []):
            key = int(ob["key"])
            cams.append(pose_pos.get(key, key))
            xys.append([float(v) for v in ob["value"]["x"]])
        obs_cam.append(np.asarray(cams, dtype=np.int32))
        obs_xy.append(np.asarray(xys, dtype=np.float64).reshape(-1, 2))

    return SfMData(
        K=Ks, R=Rs, t=ts, center=centers, widths=widths, heights=heights,
        image_paths=paths, points=pts, obs_cam=obs_cam, obs_xy=obs_xy,
        raw_doc=doc,
    )


# ----------------------------------------------------------------------
# JSON writing
# ----------------------------------------------------------------------

def sfm_data_to_doc(sfmd: SfMData, inliers: np.ndarray | None = None) -> dict:
    """Build the output document.

    Mirrors output_sfm_data.cpp:186-229: sfm_data_version / root_path /
    views / intrinsics / control_points copied verbatim from the original
    doc; extrinsics and structure regenerated from the (augmented) scene.
    Observation feature ids are the constant 0
    (output_sfm_data.cpp OUTPUT_SFMD_FEATURE_ID).
    """
    if sfmd.raw_doc is not None:
        doc = copy.deepcopy(sfmd.raw_doc)
    else:
        # no original doc (e.g. synthetic scene): synthesize minimal
        # views/intrinsics so write->read round-trips the cameras.
        doc = {"sfm_data_version": "0.3", "root_path": "",
               "views": [], "intrinsics": [], "control_points": []}
        for i in range(sfmd.n_cameras):
            doc["views"].append({
                "key": i,
                "value": {"polymorphic_id": 1073741824,
                          "ptr_wrapper": {"id": 2147483649 + i, "data": {
                              "local_path": "",
                              "filename": sfmd.image_paths[i],
                              "width": int(sfmd.widths[i]),
                              "height": int(sfmd.heights[i]),
                              "id_view": i, "id_intrinsic": i,
                              "id_pose": i}}}})
            doc["intrinsics"].append({
                "key": i,
                "value": {"polymorphic_id": 2147483649,
                          "polymorphic_name": "pinhole",
                          "ptr_wrapper": {"id": 2147483649 + sfmd.n_cameras + i,
                                          "data": {
                              "width": int(sfmd.widths[i]),
                              "height": int(sfmd.heights[i]),
                              "focal_length": float(sfmd.K[i, 0, 0]),
                              "principal_point": [float(sfmd.K[i, 0, 2]),
                                                  float(sfmd.K[i, 1, 2])],
                              "disto_k3": [0.0, 0.0, 0.0]}}}})

    doc["extrinsics"] = [
        {"key": i,
         "value": {"rotation": sfmd.R[i].tolist(),
                   "center": sfmd.center[i].tolist()}}
        for i in range(sfmd.n_cameras)
    ]

    structure = []
    for pid in range(sfmd.n_points):
        if inliers is not None and not bool(inliers[pid]):
            continue
        obs = [
            {"key": int(c),
             "value": {"id_feat": 0,
                       "x": [float(x), float(y)]}}
            for c, (x, y) in zip(sfmd.obs_cam[pid], np.asarray(sfmd.obs_xy[pid]).reshape(-1, 2))
        ]
        structure.append(
            {"key": pid,
             "value": {"X": [float(v) for v in sfmd.points[pid]],
                       "observations": obs}})
    doc["structure"] = structure
    return doc


def write_sfm_data(sfmd: SfMData, path: str, inliers: np.ndarray | None = None) -> None:
    with open(path, "w") as f:
        json.dump(sfm_data_to_doc(sfmd, inliers), f, indent=4)


# ----------------------------------------------------------------------
# Mutation
# ----------------------------------------------------------------------

def add_edge_points(
    sfmd: SfMData,
    new_points: np.ndarray,        # [N,3]
    new_obs_cam: Sequence[np.ndarray],
    new_obs_xy: Sequence[np.ndarray],
) -> SfMData:
    """Append edge-points (mirrors output_utilities.cpp:96-111
    add_3dpoints_to_sfmd); returns a new SfMData, original untouched."""
    out = sfmd.copy()
    if len(new_points):
        out.points = np.concatenate([out.points, np.asarray(new_points, dtype=np.float64)])
        out.obs_cam = out.obs_cam + [np.asarray(c, dtype=np.int32) for c in new_obs_cam]
        out.obs_xy = out.obs_xy + [np.asarray(p, dtype=np.float64).reshape(-1, 2) for p in new_obs_xy]
    return out


def remove_outliers(sfmd: SfMData, inliers: np.ndarray) -> SfMData:
    """Compact the scene to inlier points (mirrors
    outliers_filtering.cpp:66-92 removeOutliers)."""
    keep = np.flatnonzero(np.asarray(inliers, dtype=bool))
    out = sfmd.copy()
    out.points = out.points[keep]
    out.obs_cam = [sfmd.obs_cam[i] for i in keep]
    out.obs_xy = [sfmd.obs_xy[i] for i in keep]
    return out

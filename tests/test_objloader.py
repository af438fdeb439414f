"""OBJ/MTL loader unit tests (SURVEY.md section 4: 'OBJ/MTL parse counts +
material table vs known cornell values')."""

import os

import numpy as np
import pytest

import mini_opencl_raytracer as mrt


@pytest.fixture(scope="module")
def cornell_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cornell_obj")
    return mrt.write_cornell_obj(str(d))


def test_mtl_parse(cornell_files):
    _, mtl_path = cornell_files
    names, mats = mrt.load_mtl(mtl_path)
    assert names == mrt.CORNELL_MATERIAL_NAMES
    assert len(names) == 6
    np.testing.assert_allclose(mats["BloodyRed"]["diffuse"],
                               [0.445, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(mats["Light"]["emission"],
                               [1.0, 1.0, 1.0], atol=1e-6)
    assert mats["LargerBox"]["roughness"] == pytest.approx(9999.0)
    assert mats["Material"]["ior"] == pytest.approx(1.0)


def test_obj_roundtrip_matches_procedural(cornell_files):
    obj_path, _ = cornell_files
    geo, mats, names = mrt.load_obj(obj_path)
    ref = mrt.cornell_geometry()
    assert geo.num_triangles == ref.num_triangles
    np.testing.assert_allclose(np.asarray(geo.v0), np.asarray(ref.v0),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(geo.v1), np.asarray(ref.v1),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(geo.v2), np.asarray(ref.v2),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(geo.mat_idx),
                                  np.asarray(ref.mat_idx))
    # Normals: OBJ stores one normal per corner; the procedural builder
    # uses flat face normals, so they should match exactly.
    np.testing.assert_allclose(np.asarray(geo.n0), np.asarray(ref.n0),
                               atol=1e-5)


def test_fan_triangulation(tmp_path):
    """A pentagon face must fan into 3 triangles (reference fan:
    CLOBJloader.cpp:101-126)."""
    obj = tmp_path / "pent.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0.5 1.5 0\nv 0 1 0\n"
        "f 1 2 3 4 5\n")
    geo, _, _ = mrt.load_obj(str(obj))
    assert geo.num_triangles == 3
    # All fan triangles share corner 0.
    np.testing.assert_allclose(np.asarray(geo.v0),
                               np.zeros((3, 3)), atol=1e-6)


def test_missing_normals_get_face_normal(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    geo, _, _ = mrt.load_obj(str(obj))
    np.testing.assert_allclose(np.asarray(geo.n0), [[0, 0, 1]], atol=1e-6)


def test_negative_indices(tmp_path):
    obj = tmp_path / "neg.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    geo, _, _ = mrt.load_obj(str(obj))
    assert geo.num_triangles == 1
    np.testing.assert_allclose(np.asarray(geo.v1), [[1, 0, 0]], atol=1e-6)


def test_native_parser_matches_python(cornell_files):
    """The C++ OBJ parser must produce the same buffers as the Python
    parser (skips without a compiler). Native material slots are in
    usemtl-appearance order and must be remapped to MTL-declaration
    order by name — exactly what load_obj's integration does."""
    from mini_opencl_raytracer import native
    if not native.available():
        import pytest
        pytest.skip("native library unavailable")
    obj_path, _ = cornell_files
    res = native.parse_obj_native(obj_path)
    assert res is not None
    v, n, uv, mat, names = res
    geo, _, pynames = mrt.load_obj(obj_path, use_native=False)
    assert v.shape[1] == geo.num_triangles
    np.testing.assert_allclose(v[0], np.asarray(geo.v0), atol=1e-5)
    np.testing.assert_allclose(v[1], np.asarray(geo.v1), atol=1e-5)
    np.testing.assert_allclose(v[2], np.asarray(geo.v2), atol=1e-5)
    np.testing.assert_allclose(n[0], np.asarray(geo.n0), atol=1e-5)
    np.testing.assert_allclose(uv[2], np.asarray(geo.uv2), atol=1e-5)
    # Remap usemtl-appearance slots to MTL declaration order by name.
    remap = np.array([pynames.index(nm) for nm in names], np.int32)
    np.testing.assert_array_equal(remap[mat], np.asarray(geo.mat_idx))


def test_load_obj_native_path_matches_python(cornell_files):
    """load_obj must actually use the native parser when available and
    produce buffers identical to the pure-Python path."""
    from mini_opencl_raytracer import native
    from mini_opencl_raytracer.models import objloader
    if not native.available():
        import pytest
        pytest.skip("native library unavailable")
    obj_path, _ = cornell_files
    # The native fast path must be taken (not silently fall back).
    name_to_idx = {n: i for i, n in
                   enumerate(mrt.load_mtl(obj_path[:-4] + ".mtl")[0])}
    assert objloader._native_triangles(obj_path, name_to_idx) is not None

    import jax.tree_util as jtu
    geo_n, mats_n, names_n = mrt.load_obj(obj_path, use_native=True)
    geo_p, mats_p, names_p = mrt.load_obj(obj_path, use_native=False)
    assert names_n == names_p
    for fn, fp in zip(jtu.tree_leaves((geo_n, mats_n)),
                      jtu.tree_leaves((geo_p, mats_p))):
        np.testing.assert_allclose(np.asarray(fn), np.asarray(fp), atol=1e-6)


def test_native_pre_usemtl_faces_get_material_zero(tmp_path):
    """Faces before any usemtl line map to material 0 through the native
    path (the C++ parser emits slot -1 for them)."""
    from mini_opencl_raytracer import native
    if not native.available():
        import pytest
        pytest.skip("native library unavailable")
    obj = tmp_path / "pre.obj"
    obj.write_text("mtllib pre.mtl\n"
                   "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                   "f 1 2 3\n"
                   "usemtl B\nf 1 2 3\n")
    (tmp_path / "pre.mtl").write_text(
        "newmtl A\nKd 1 0 0\nnewmtl B\nKd 0 1 0\n")
    geo_n, _, _ = mrt.load_obj(str(obj), use_native=True)
    geo_p, _, _ = mrt.load_obj(str(obj), use_native=False)
    np.testing.assert_array_equal(np.asarray(geo_n.mat_idx), [0, 1])
    np.testing.assert_array_equal(np.asarray(geo_p.mat_idx),
                                  np.asarray(geo_n.mat_idx))

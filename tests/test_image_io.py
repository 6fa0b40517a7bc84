"""Image input formats: the reference loads any
stb-supported format as linear float via stbi_loadf (image.cpp:14-29)
and hooks `EnvMap <file>.hdr` env maps through it (scene.cpp:122-128).
Covers: Radiance RGBE .hdr read (flat + adaptive RLE), JPG via PIL,
PFM, sRGB linearization of LDR textures, and an end-to-end scene file
with an .hdr env map rendering through the renderer.
"""

import textwrap

import numpy as np
import pytest

from restir_tpu.utils.image_io import (
    read_hdr,
    read_pfm,
    write_hdr,
    write_pfm,
)


def _test_img(h=12, w=20, scale=4.0):
    rng = np.random.RandomState(7)
    img = rng.rand(h, w, 3).astype(np.float32) * scale
    img[0, 0] = 0.0  # exercise the zero-exponent path
    return img


def test_hdr_round_trip_flat():
    img = _test_img()
    path = "/tmp/_t_roundtrip.hdr"
    write_hdr(path, img)
    got = read_hdr(path)
    assert got.shape == img.shape
    # RGBE: 8-bit mantissa shared across channels -> ~1/256 of the max
    # channel per pixel
    m = img.max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - img) <= m / 128.0 + 1e-6)
    assert np.all(got[0, 0] == 0.0)


def test_hdr_rle_decode():
    """Hand-encoded adaptive-RLE scanline (the format external tools
    emit; our writer only emits flat)."""
    w = 16
    # one row: R = run of 16 x 64; G = two literals 8+8 ascending;
    # B = run 16 x 0; E = run of 16 x 128 (=> 2^(128-136) = 1/256)
    row = bytearray([2, 2, w >> 8, w & 0xFF])
    row += bytes([128 + 16, 64])                       # R run
    row += bytes([8]) + bytes(range(8))                # G literal
    row += bytes([8]) + bytes(range(8, 16))            # G literal
    row += bytes([128 + 16, 0])                        # B run
    row += bytes([128 + 16, 128])                      # E run
    path = "/tmp/_t_rle.hdr"
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y 1 +X {w}\n".encode())
        f.write(bytes(row))
    got = read_hdr(path)
    assert got.shape == (1, w, 3)
    np.testing.assert_allclose(got[0, :, 0], (64 + 0.5) / 256.0, rtol=1e-6)
    np.testing.assert_allclose(
        got[0, :, 1], (np.arange(16) + 0.5) / 256.0, rtol=1e-6)
    np.testing.assert_allclose(got[0, :, 2], 0.5 / 256.0, rtol=1e-6)


def test_pfm_round_trip():
    img = _test_img()
    path = "/tmp/_t_roundtrip.pfm"
    write_pfm(path, img)
    np.testing.assert_array_equal(read_pfm(path), img)


def test_load_texture_formats(tmp_path):
    """_load_texture: .hdr/.pfm stay linear, LDR gets stb's gamma-2.2
    linearization (stbi_loadf, image.cpp:30), data maps stay raw."""
    from restir_tpu.scene.loader import _load_texture

    img = _test_img(8, 8, scale=2.0)
    write_hdr(str(tmp_path / "t.hdr"), img)
    got = _load_texture(str(tmp_path / "t.hdr"), flip=False)
    m = img.max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - img) <= m / 128.0 + 1e-6)

    write_pfm(str(tmp_path / "t.pfm"), img)
    np.testing.assert_array_equal(
        _load_texture(str(tmp_path / "t.pfm"), flip=False), img)

    # LDR: PNG through the native reader, sRGB-linearized
    from restir_tpu.utils.image_io import write_png

    ldr = (np.clip(img / 2.0, 0, 1) * 255).astype(np.uint8)
    write_png(str(tmp_path / "t.png"), ldr)
    got = _load_texture(str(tmp_path / "t.png"), flip=False)
    np.testing.assert_allclose(
        got, (ldr.astype(np.float32) / 255.0) ** 2.2, rtol=1e-5)
    # srgb=False (metallic/roughness/normal maps): raw values
    got = _load_texture(str(tmp_path / "t.png"), flip=False, srgb=False)
    np.testing.assert_allclose(got, ldr.astype(np.float32) / 255.0,
                               rtol=1e-5)

    # JPG via PIL (lossy -> smooth test image, loose tolerance)
    PIL = pytest.importorskip("PIL.Image")
    grad = np.broadcast_to(
        np.linspace(0, 255, 32, dtype=np.float32)[None, :, None],
        (32, 32, 3)).astype(np.uint8)
    PIL.fromarray(grad).save(str(tmp_path / "t.jpg"), quality=95)
    got = _load_texture(str(tmp_path / "t.jpg"), flip=False, srgb=False)
    assert got.shape == (32, 32, 3)
    assert np.abs(got - grad / 255.0).mean() < 0.02


ENV_SCENE = textwrap.dedent("""\
    Material white
    Type Lambertian
    BaseColor 0.8 0.7 0.6
    Metallic 0
    Roughness 1
    Ior 1.5
    NormalMap Null

    Camera
    Resolution 128 16
    FovY 45
    LensRadius 0
    FocalDist 1
    ApertureMask Null
    Sample 8
    Depth 5
    File out_env
    Eye 0 1 4
    Rotation 90 0 0
    Up 0 1 0

    Object floor
    quad.obj
    Material white
    Scale 4 1 4

    EnvMap sky.hdr
""")

QUAD_OBJ = textwrap.dedent("""\
    v -1 0 -1
    v 1 0 -1
    v 1 0 1
    v -1 0 1
    vn 0 1 0
    f 1//1 2//1 3//1 4//1
""")


def test_env_map_hdr_scene_renders(tmp_path):
    """`EnvMap sky.hdr` in a reference-format scene file loads through
    read_hdr, builds env-tile CDF rows, and renders finite non-black
    frames through renderer.step_jit (scene.cpp:122-128 parity)."""
    from restir_tpu import renderer
    from restir_tpu.config import RenderConfig, TracerType
    from restir_tpu.scene.loader import parse_scene_file

    eh, ew = 16, 32
    sky = np.zeros((eh, ew, 3), np.float32)
    sky[:, :, 2] = 2.0  # blue-ish sky
    sky[: eh // 4] = [8.0, 8.0, 6.0]  # bright top band (the "sun")
    write_hdr(str(tmp_path / "sky.hdr"), sky)
    (tmp_path / "quad.obj").write_text(QUAD_OBJ)
    (tmp_path / "scene.txt").write_text(ENV_SCENE)

    sf = parse_scene_file(str(tmp_path / "scene.txt"))
    assert sf.env_map is not None and sf.env_map.shape == (eh, ew, 3)
    m = sky.max(axis=-1, keepdims=True)
    assert np.all(np.abs(sf.env_map - sky) <= m / 128.0 + 1e-6)

    scene = sf.build(bvh_impl="numpy")
    assert float(np.asarray(scene.env_tile_rad).max()) > 0.0

    cfg = RenderConfig(width=128, height=16, tracer=TracerType.RESTIR_DI,
                       ris_mode="cdf", has_env_map=True)
    cam = sf.make_camera()
    state, frame = renderer.render(scene, cam, cfg, 3)
    img = np.asarray(frame)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01  # env light actually illuminates the floor

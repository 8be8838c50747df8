"""The port's native loader (data/native_loader.py, its own copy of
native/ucsa_loader.cpp built into build/torch_native/) against the JAX
package's native_loader through the public functions, and against the
port's image_io path, on files written here.

The JAX loader is called on the repository's native/libucsa_loader.so as
it is: its build() is replaced by one that returns that file, so that
nothing here compiles or writes it. Tolerances: bit-equal to JAX's
loader; against image_io labels and depth bit-equal, RGB within the
decoders' and the resizes' rounding, max |Δ| ≤ 1/255 + 1e-6.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ucsa_neural_rendering_tpu_torch.data import native_loader
from ucsa_neural_rendering_tpu_torch.data.image_io import (read_png, read_rgb,
                                                           resize_area,
                                                           resize_nearest,
                                                           write_jpeg,
                                                           write_png)
from ucsa_neural_rendering_tpu_torch.data.scannet_ngp import ScanNetNGP
from ucsa_neural_rendering_tpu_torch.data.scannet_ngp_joint import \
    ScanNetNGPJoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RGB_TOL = 1 / 255 + 1e-6
SIZES = [(48, 64), (24, 32), (17, 23), (70, 100)]  # (h, w)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """RGB as JPEG, PNG and RGBA PNG; labels as 8- and 16-bit PNG; depth
    as a 16-bit millimetre PNG; all 48 × 64."""
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:48, :64]
    smooth = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1) % 256
    noisy = rng.integers(0, 256, (48, 64, 3))
    out = {"jpg": str(d / "c.jpg"), "png": str(d / "c.png"),
           "rgba": str(d / "c4.png"), "lab8": str(d / "l8.png"),
           "lab16": str(d / "l16.png"), "depth": str(d / "d.png")}
    write_jpeg(out["jpg"], ((smooth + noisy) // 2).astype(np.uint8))
    write_png(out["png"], noisy.astype(np.uint8))
    write_png(out["rgba"], np.concatenate(
        [noisy, rng.integers(0, 256, (48, 64, 1))], -1).astype(np.uint8))
    write_png(out["lab8"], rng.integers(0, 41, (48, 64)).astype(np.uint8))
    write_png(out["lab16"], rng.integers(0, 1500, (48, 64)).astype(np.uint16))
    write_png(out["depth"], rng.integers(0, 8000, (48, 64)).astype(np.uint16))
    return out


@pytest.fixture
def jax_loader(monkeypatch):
    """The JAX package's native_loader on the repository's binary as it
    is (module docstring)."""
    sys.path.insert(0, REPO)
    try:
        import native.build as nb
    finally:
        sys.path.remove(REPO)
    from ucsa_neural_rendering_tpu.data import native_loader as jnl
    monkeypatch.setattr(nb, "build", lambda force=False: nb.LIB)
    monkeypatch.setattr(jnl, "_tried", False)
    monkeypatch.setattr(jnl, "_lib", None)
    monkeypatch.delenv("UCSA_NATIVE_LOADER", raising=False)
    if not jnl.available():
        pytest.fail("the JAX package's native loader does not load")
    return jnl


@pytest.fixture
def port_loader(monkeypatch):
    monkeypatch.delenv("UCSA_NATIVE_LOADER", raising=False)
    native_loader.reset()
    st = native_loader.status()
    assert (st["available"], st["reason"], st["library"], st["mode"]) == (
        True, None, str(native_loader.LIB), None)
    yield native_loader
    native_loader.reset()


@pytest.mark.parametrize("hw", SIZES)
def test_bit_equal_to_jax_native_loader(files, jax_loader, port_loader, hw):
    h, w = hw
    for key in ("jpg", "png", "rgba"):
        a, b = port_loader.load_rgb(files[key], w, h), \
            jax_loader.load_rgb(files[key], w, h)
        assert a.dtype == b.dtype == np.float32 and a.shape == (h, w, 3)
        np.testing.assert_array_equal(a, b)
    for key in ("lab8", "lab16"):
        np.testing.assert_array_equal(port_loader.load_label(files[key], w, h),
                                      jax_loader.load_label(files[key], w, h))
    np.testing.assert_array_equal(port_loader.load_depth(files["depth"], w, h),
                                  jax_loader.load_depth(files["depth"], w, h))
    paths = [files["jpg"], files["png"], files["rgba"]]
    a, sa = port_loader.load_rgb_batch(paths, w, h)
    b, sb = jax_loader.load_rgb_batch(paths, w, h)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", SIZES[:3])  # image_io's area resize shrinks
def test_within_rounding_of_image_io(files, port_loader, hw):
    h, w = hw
    for key in ("jpg", "png", "rgba"):
        got = port_loader.load_rgb(files[key], w, h)
        ref = resize_area(read_rgb(files[key]).astype(np.float32) / 255.0,
                          (h, w))
        assert np.abs(got - ref).max() <= RGB_TOL, (key, np.abs(got - ref)
                                                    .max())
    for key in ("lab8", "lab16"):
        np.testing.assert_array_equal(
            port_loader.load_label(files[key], w, h),
            resize_nearest(read_png(files[key]), (h, w)).astype(np.int32))
    np.testing.assert_array_equal(
        port_loader.load_depth(files["depth"], w, h),
        resize_nearest(read_png(files["depth"]), (h, w)).astype(np.float32)
        / 1000.0)


def test_rgb_batch_reports_failures(files, port_loader, tmp_path):
    """Status 0 where a file decodes (its row equal to load_rgb's), not 0
    for a missing file, a file that is no image, a 16-bit PNG and a
    one-channel PNG; single loads of those give None."""
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"not an image")
    bad = [str(tmp_path / "missing.jpg"), str(junk), files["lab16"],
           files["lab8"]]
    paths = [files["jpg"], *bad, files["png"]]
    batch, status = port_loader.load_rgb_batch(paths, 32, 24)
    assert status[0] == 0 and status[-1] == 0
    assert (status[1:-1] != 0).all()
    for i in (0, len(paths) - 1):
        np.testing.assert_array_equal(batch[i],
                                      port_loader.load_rgb(paths[i], 32, 24))
    for p in bad:
        assert port_loader.load_rgb(p, 32, 24) is None
    assert port_loader.load_label(files["jpg"], 32, 24) is None
    assert port_loader.load_depth(files["lab8"], 32, 24) is None


def test_unavailable_loader_states_its_reason(monkeypatch, tmp_path, capsys):
    """A build that fails (a compiler that does not exist, a library not
    yet built): UCSA_NATIVE_LOADER=1 raises with the reason; unset prints
    the reason once and returns None (the datasets then read through
    image_io); 0 is off without building."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native_loader, "LIB", tmp_path / "b" / "lib.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    try:
        monkeypatch.setenv("UCSA_NATIVE_LOADER", "1")
        native_loader.reset()
        with pytest.raises(native_loader.NativeLoaderError,
                           match="UCSA_NATIVE_LOADER=1.*no-such-compiler.*"
                                 "not found"):
            native_loader.load_rgb("x.jpg", 4, 4)
        with pytest.raises(native_loader.NativeLoaderError):
            native_loader.status()

        monkeypatch.delenv("UCSA_NATIVE_LOADER")
        native_loader.reset()
        assert native_loader.load_label("x.png", 4, 4) is None
        assert native_loader.load_rgb_batch(["x.jpg"], 4, 4) == (None, None)
        st = native_loader.status()
        assert not st["available"] and "no-such-compiler" in st["reason"]
        printed = capsys.readouterr().out
        assert printed.count("[native_loader] unavailable") == 1
        assert "no-such-compiler" in printed

        monkeypatch.setenv("UCSA_NATIVE_LOADER", "0")
        native_loader.reset()
        assert native_loader.status()["reason"] == "off (UCSA_NATIVE_LOADER=0)"
        assert not native_loader.LIB.exists()
    finally:
        native_loader.reset()


def test_a_library_that_does_not_load_is_built_anew(monkeypatch, tmp_path):
    """A library newer than its source that does not load here (one built
    on another machine and copied with the tree, whose runtime libraries
    this machine lacks) is built anew, once, and then loads."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native_loader, "LIB", tmp_path / "b" / "lib.so")
    monkeypatch.delenv("UCSA_NATIVE_LOADER", raising=False)
    native_loader.LIB.parent.mkdir()
    native_loader.LIB.write_bytes(b"not a shared library")
    assert native_loader.LIB.stat().st_mtime >= \
        native_loader.SRC.stat().st_mtime
    try:
        native_loader.reset()
        st = native_loader.status()
        assert st["available"] and st["reason"] is None, st
        assert native_loader.LIB.read_bytes()[:4] == b"\x7fELF"
    finally:
        native_loader.reset()


def test_route_b_links_bundled_libraries_by_file_name(files, port_loader,
                                                     tmp_path, monkeypatch):
    """Route b as on a machine without the development packages: the
    carried headers and the libraries bundled beside a Python package (of
    the headers' ABI), linked by file name with an rpath. Its reads equal
    route a's: PNG bit for bit, JPEG within one level (another
    libjpeg-turbo release may round its IDCT otherwise)."""
    import ctypes
    import glob
    import site
    import sysconfig
    roots = set(site.getsitepackages()) | {
        sysconfig.get_paths()[k] for k in ("purelib", "platlib")}
    bundles = sorted(d for r in roots for d in glob.glob(f"{r}/*.libs"))
    monkeypatch.setattr(native_loader, "_library_dirs", lambda: bundles)
    libs = native_loader.runtime_libraries()
    if None in libs.values():
        pytest.fail(f"no bundled libjpeg.so.62 / libpng16.so.16 in "
                    f"{bundles}: {libs}")
    out = str(tmp_path / "route_b.so")
    (route, cmd), = [c for c in native_loader._commands(out) if c[0] == "b"]
    assert f"-I{native_loader.INCLUDE}" in cmd
    assert all(f in cmd for f in libs.values())
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    ldd = subprocess.run(["ldd", out], capture_output=True, text=True).stdout
    for f in libs.values():
        assert os.path.basename(f) in ldd and "not found" not in ldd, ldd
    lib = native_loader._bind(ctypes.CDLL(out))
    monkeypatch.setattr(native_loader, "_lib", lib)
    b = {k: native_loader.load_rgb(files[k], 23, 17)
         for k in ("jpg", "png", "rgba")}
    b["lab16"] = native_loader.load_label(files["lab16"], 23, 17)
    b["depth"] = native_loader.load_depth(files["depth"], 23, 17)
    monkeypatch.undo()
    native_loader.reset()
    a = {k: native_loader.load_rgb(files[k], 23, 17)
         for k in ("jpg", "png", "rgba")}
    a["lab16"] = native_loader.load_label(files["lab16"], 23, 17)
    a["depth"] = native_loader.load_depth(files["depth"], 23, 17)
    for k in ("png", "rgba", "lab16", "depth"):
        np.testing.assert_array_equal(a[k], b[k])
    assert np.abs(a["jpg"] - b["jpg"]).max() <= RGB_TOL


def test_reason_names_the_missing_header_or_library():
    assert native_loader._first_error(
        "x.cpp:27:10: fatal error: jpeglib.h: No such file or directory\n"
    ) == "header jpeglib.h not found"
    assert native_loader._first_error(
        "/usr/bin/ld: cannot find -lpng: No such file or directory\n"
        "collect2: error: ld returned 1 exit status\n"
    ) == "library -lpng not found"


def test_build_writes_only_under_build_torch_native(tmp_path):
    """A forced build in a fresh process, with an audit hook on every
    open for writing, subprocess and dlopen: the compiler writes the
    library under build/torch_native/, the process writes nothing else,
    and the repository's native/build.py and native/libucsa_loader.so are
    neither imported, run nor opened."""
    script = textwrap.dedent(f"""
        import json, os, sys
        events = []
        def hook(name, args):
            if name == "open" and args[1] is not None and (
                    "w" in str(args[1]) or "a" in str(args[1]) or
                    "+" in str(args[1]) or (isinstance(args[2], int)
                                            and args[2] & 0o3)):
                events.append(("write", str(args[0])))
            elif name == "open":
                events.append(("read", str(args[0])))
            elif name == "subprocess.Popen":
                events.append(("run", [str(a) for a in args[1]]))
            elif name == "ctypes.dlopen":
                events.append(("dlopen", str(args[0])))
        sys.addaudithook(hook)
        from ucsa_neural_rendering_tpu_torch.data import native_loader as n
        n.build(force=True)
        n.reset()
        assert n.available()
        print(json.dumps({{"events": events,
                          "native_build": "native.build" in sys.modules,
                          "lib": str(n.LIB)}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    import json
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    build_dir = os.path.join(REPO, "build", "torch_native")
    assert got["lib"] == os.path.join(build_dir, "libucsa_loader.so")
    assert not got["native_build"]
    runs = [e[1] for e in got["events"] if e[0] == "run"]
    assert len(runs) == 1
    out = runs[0][runs[0].index("-o") + 1]
    assert os.path.dirname(out) == build_dir
    writes = [e[1] for e in got["events"]
              if e[0] == "write" and e[1] != os.devnull]
    assert all(os.path.dirname(os.path.abspath(w)) == build_dir
               for w in writes), writes
    forbidden = (os.path.join(REPO, "native", "build.py"),
                 os.path.join(REPO, "native", "libucsa_loader.so"))
    for kind, arg in got["events"]:
        for f in forbidden:
            assert f not in (arg if isinstance(arg, list) else [arg]), \
                (kind, arg)


@pytest.mark.parametrize("off", [False, True])
def test_datasets_read_natively_as_image_io_reads(tmp_path, monkeypatch, off):
    """ScanNetNGPJoint's and ScanNetNGP's reads with the loader on and off
    (UCSA_NATIVE_LOADER=0): labels and depth bit-equal, RGB within
    rounding; the joint set's labels are the raw value − 1 as int64, the
    finetune set's the raw value as float32, depth in metres."""
    from ucsa_neural_rendering_tpu_torch.data.synthetic import \
        write_synthetic_scene_dir
    write_synthetic_scene_dir(str(tmp_path), "scene0000_00", n_frames=5,
                              H=24, W=32)
    scene = tmp_path / "scene0000_00"
    rgb = str(scene / "color_scaled" / "0.jpg")
    label = str(scene / "label_40_scaled" / "0.png")
    depth = str(scene / "depth" / "0.png")
    joint = ScanNetNGPJoint(root=str(tmp_path), mode="val",
                            scene_list=["scene0000_00"], exp_name="e",
                            output_size=(12, 16),
                            val_scene_list=["scene0000_00"])
    ngp = ScanNetNGP(root=str(tmp_path), mode="val",
                     scene_list=["scene0000_00"], output_size=(12, 16))

    def reads():
        return (joint._read_rgb(rgb), joint._read_label(label),
                joint._read_depth(depth), ngp._read_rgb(rgb),
                ngp._read_label(label))

    monkeypatch.delenv("UCSA_NATIVE_LOADER", raising=False)
    native_loader.reset()
    try:
        on = reads()
        monkeypatch.setenv("UCSA_NATIVE_LOADER", "0" if off else "1")
        native_loader.reset()
        other = reads()
    finally:
        native_loader.reset()
    assert native_loader.LIB.is_file()
    for a, b in zip(on, other):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert on[1].dtype == np.int64 and on[4].dtype == np.float32
    assert on[2].dtype == np.float32
    for i in (0, 3):
        assert np.abs(on[i] - other[i]).max() <= (RGB_TOL if off else 0.0)
    for i in (1, 2, 4):
        np.testing.assert_array_equal(on[i], other[i])

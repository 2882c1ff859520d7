"""kernels/build.py builds safely from several processes at once: two
processes that call build() on a fresh build directory (as the ranks of
granite_tpu_torch.parallel can) both get the one library, built once,
against a fake nvcc on PATH that links only the object files it finds."""

import os
import stat
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    with open(out + ".log", "a") as log:
        log.write("x")
    if "-c" in args:
        time.sleep(0.5)                     # two builds overlap here
        with open(out, "w") as f:
            f.write("obj " + args[-1].rsplit("/", 1)[-1] + "\\n")
    else:
        objs = [a for a in args if a.endswith(".o")]
        with open(out, "w") as f:           # raises on a missing object
            f.write("".join(open(o).read() for o in objs))
""")

BUILD = textwrap.dedent("""\
    import sys
    from pathlib import Path
    from granite_tpu_torch.kernels import build as K
    K.BUILD_DIR = Path(sys.argv[1])
    print(K.build())
""")


def test_two_processes_build_one_library(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    out_dir = tmp_path / "build"
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(out_dir)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in results}
    assert len(paths) == 1
    lib = paths.pop()
    from granite_tpu_torch.kernels import build as K
    sources = sorted(s.name for s in K.CSRC_DIR.glob("*.cu"))
    assert open(lib).read() == "".join(f"obj {s}\n" for s in sources)
    # built once: each source compiled once and one link
    logs = sorted(p.name for p in out_dir.glob("*.log"))
    assert len(logs) == len(sources) + 1
    assert all((out_dir / name).read_text() == "x" for name in logs)
    assert not list(out_dir.glob("*.o"))

"""`elasticdl zoo init|build|push` (client/image_builder.py) against the
JAX package's: `init` writes the Dockerfile at the same path, equal but
for the package lines (torch in place of the JAX stack, the port's
master entry point); with no docker CLI (neither machine has one)
`build` and `push` fail as the JAX ones do, and `build` writes the
Dockerfile first."""

import os

import pytest

from elasticdl_tpu.client import image_builder as jax_builder
from elasticdl_tpu.client import main as jax_cli
from elasticdl_tpu_torch.client import image_builder
from elasticdl_tpu_torch.client import main as cli

# the lines that name packages: the pip install (two lines) and the
# entry point
PACKAGE_LINES = {1, 2, 6}


def _init_both(tmp_path, *flags):
    out = []
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        zoo = tmp_path / name / "my_zoo"
        assert main(["zoo", "init", "--model_zoo", str(zoo), *flags]) == 0
        out.append((zoo / "Dockerfile").read_text().splitlines())
    return out


@pytest.mark.parametrize("flags", [[], ["--base_image", "nvcr.io/pt:1"]])
def test_init_writes_the_jax_dockerfile_but_for_the_packages(tmp_path,
                                                             flags):
    jax_lines, port_lines = _init_both(tmp_path, *flags)
    assert len(port_lines) == len(jax_lines)
    differ = {i for i, (a, b) in enumerate(zip(jax_lines, port_lines))
              if a != b}
    assert differ == PACKAGE_LINES
    assert port_lines[0] == f"FROM {flags[1] if flags else 'python:3.12'}"
    assert port_lines[3] == "COPY my_zoo /app/model_zoo"
    assert "torch" in port_lines[1] and "jax" not in " ".join(port_lines)
    assert port_lines[6] == ('ENTRYPOINT ["python", "-m", '
                             '"elasticdl_tpu_torch.master.main"]')


def test_build_and_push_without_docker_fail_as_the_jax_ones(tmp_path,
                                                            monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    for builder, name in ((jax_builder, "jax"), (image_builder, "port")):
        zoo = str(tmp_path / name / "zoo")
        assert builder.build_image(zoo, "registry/img:1") == 1
        # the Dockerfile is written all the same, to build elsewhere
        assert os.path.isfile(os.path.join(zoo, "Dockerfile"))
        assert builder.push_image("registry/img:1") == 1
    assert cli.main(["zoo", "build", "--model_zoo",
                     str(tmp_path / "cli" / "zoo"), "--image", "x:1"]) == 1
    assert cli.main(["zoo", "push", "x:1"]) == 1


def test_zoo_subcommands_parse_as_the_jax_ones():
    for argv in (["zoo", "init"], ["zoo", "init", "--model_zoo", "z",
                                   "--base_image", "b"],
                 ["zoo", "build", "--image", "i"], ["zoo", "push", "i"]):
        got = vars(cli.parse_args(argv))
        want = vars(jax_cli._build_parser().parse_args(argv))
        assert got == want
    with pytest.raises(SystemExit):
        cli.parse_args(["zoo", "build"])            # --image is required

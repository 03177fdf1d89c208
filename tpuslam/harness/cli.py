"""Command-line entry — the reference's ``Common::Main``
(``mainwrapper.cpp:5-54``): parse config -> echo -> seed -> build clouds ->
run the registered algorithm -> print R/t/error -> optional visualization.

Usage (the reference's CLI contract, ``configparser.cpp:11-39``):

    python -m tpuslam [config.json]

plus a ``--test-set`` mode replacing the reference's compile-time ``TEST``
macro (``gpumain.cpp:40-57`` — SURVEY §2.4 "TEST hook"):

    python -m tpuslam --test-set sizes [--methods icp,nicp,cpd] [--out DIR]
                      [--warmup] [--resume]

``--platform cpu|gpu`` (before any other argument) forces the JAX
backend — e.g. ``--platform cpu`` runs the jnp reference paths on a
machine that has a GPU.

The persistent compile cache lives in ``JAX_COMPILATION_CACHE_DIR`` when
that is set, else in ``<checkout>/.jax_cache``.

``--serve`` runs a warm JSONL registration service on stdin/stdout
(see ``run_serve``): one process, many registrations, compile cache
kept hot.

``--warmup`` runs each test once untimed before the timed run so jit
compilation never lands in the CSV ``time(ms)`` column.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from tpuslam.algorithms.registry import run_with_configuration
from tpuslam.config.configuration import ComputationMethod
from tpuslam.config.parser import ConfigParser
from tpuslam.data.synthesis import get_clouds_from_config, transform_cloud


def _print_matrix(rotation: np.ndarray, translation: np.ndarray) -> None:
    """Result echo in the spirit of ``PrintMatrix``
    (``common.cpp:367-397``)."""
    for r in range(3):
        row = " ".join(f"{rotation[r, c]: .6f}" for c in range(3))
        print(f"{row}  | {translation[r]: .6f}")


def run_config(argv: List[str]) -> int:
    parser = ConfigParser(argv)
    if not parser.is_correct():
        print("Aborting!")
        return 1
    config = parser.get_configuration()
    config.print()

    before, after, _ = get_clouds_from_config(config)
    if len(before) == 0 or len(after) == 0:
        print("Empty cloud(s) — nothing to register")
        return 1

    rotation, translation, iterations, error = run_with_configuration(
        before, after, config
    )
    print(f"Results for the {config.computation_method.value} method:")
    print("Transformation matrix:")
    _print_matrix(rotation, translation)
    print(f"Error: {error:f}")
    print(f"Iterations: {iterations}")

    if config.save_output_path:
        from tpuslam.data.writer import save_cloud

        out_pts = transform_cloud(before, rotation, translation)
        if save_cloud(config.save_output_path, out_pts):
            print(f"Transformed cloud saved to {config.save_output_path}")
        else:
            print(
                f"Could not save transformed cloud to "
                f"{config.save_output_path} (.obj/.off, writable path)"
            )

    if config.show_visualisation:
        from tpuslam.viz.view import show_registration
        from tpuslam.viz.webgl import export_html

        transformed = transform_cloud(before, rotation, translation)
        # interactive artifact (the reference opens a GLFW window,
        # mainwrapper.cpp:39-51; on a headless GPU host the equivalent
        # is a self-contained WebGL HTML) + static PNG fallback
        export_html(before, after, transformed)
        show_registration(before, after, transformed)
    return 0


def run_test_set_cli(args: List[str]) -> int:
    from tpuslam.harness.runner import run_test_set
    from tpuslam.harness.testsets import TEST_SETS

    name = args[0] if args else "sizes"
    if name not in TEST_SETS:
        print(f"Unknown test set '{name}'; one of {sorted(TEST_SETS)}")
        return 1
    methods = list(ComputationMethod)
    out_dir = "."
    warmup = False
    resume = False
    rest = args[1:]
    while rest:
        flag = rest.pop(0)
        if flag == "--methods" and rest:
            try:
                methods = [
                    ComputationMethod(m.strip())
                    for m in rest.pop(0).split(",")
                ]
            except ValueError as exc:
                print(
                    f"Unknown method ({exc}); one of "
                    f"{[m.value for m in ComputationMethod]}"
                )
                return 1
        elif flag == "--out" and rest:
            out_dir = rest.pop(0)
        elif flag == "--warmup":
            # run each test once untimed first (jit compile excluded
            # from the recorded time)
            warmup = True
        elif flag == "--resume":
            # continue an interrupted run: keep completed CSV rows and
            # skip their configurations
            resume = True
        else:
            print(f"Unknown flag {flag}")
            return 1
    if name == "noise":
        # the noise suite carries a ground-truth grading sidecar
        # (noise-tiers-<method>.jsonl) on top of the reference CSV
        from tpuslam.harness.noise import run_noise_test_set

        files = run_noise_test_set(
            methods, output_dir=out_dir, warmup=warmup, resume=resume
        )
    else:
        files = run_test_set(
            TEST_SETS[name], name, methods, output_dir=out_dir,
            warmup=warmup, resume=resume,
        )
    print("Wrote: " + ", ".join(files))
    return 0


def run_serve(inp=None, out=None) -> int:
    """``--serve``: a warm registration service on stdin/stdout.

    Production pattern the one-shot CLI cannot offer: ONE process keeps
    the jit/compile cache and device context warm across many
    registrations (first compile of a shape is expensive; repeats are
    milliseconds).  Protocol: one
    JSON request per line, the same key contract as a config file
    (``config/schema.json``); one JSON response per line:

        {"ok": true, "rotation": [[...]x3], "translation": [...],
         "iterations": N, "error": E}
      | {"ok": false, "error": "..."}

    Responses are the ONLY stdout output; all diagnostics (config echo,
    parse errors) go to stderr.  EOF ends the loop."""
    import contextlib
    import json as _json

    inp = sys.stdin if inp is None else inp
    out = sys.stdout if out is None else out
    served = 0
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            request = _json.loads(line)
            if not isinstance(request, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            out.write(_json.dumps({"ok": False, "error": str(exc)}) + "\n")
            out.flush()
            served += 1
            continue
        # a single bad request must never end the service: anything the
        # pipeline raises (synthesis on degenerate values, registration
        # on adversarial parameters) becomes an error response
        try:
            with contextlib.redirect_stdout(sys.stderr):
                parser = ConfigParser.from_dict(request)
                if not parser.is_correct():
                    response = {"ok": False, "error": "invalid config"}
                else:
                    config = parser.get_configuration()
                    before, after, _ = get_clouds_from_config(config)
                    if len(before) == 0 or len(after) == 0:
                        response = {"ok": False, "error": "empty cloud(s)"}
                    else:
                        rotation, translation, iterations, error = (
                            run_with_configuration(before, after, config)
                        )
                        if config.save_output_path:
                            from tpuslam.data.writer import save_cloud

                            save_cloud(
                                config.save_output_path,
                                transform_cloud(
                                    before, rotation, translation
                                ),
                            )
                        response = {
                            "ok": True,
                            "rotation": np.asarray(rotation).tolist(),
                            "translation": np.asarray(translation).tolist(),
                            "iterations": int(iterations),
                            "error": float(error),
                        }
        except Exception as exc:  # noqa: BLE001 — keep serving
            response = {"ok": False, "error": repr(exc)}
        out.write(_json.dumps(response) + "\n")
        out.flush()
        served += 1
    print(f"Served {served} request(s)", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) >= 2 and argv[0] == "--platform":
        # force a JAX backend before any jax use touches the device
        # (harness extension, like --test-set)
        if argv[1] not in ("cpu", "gpu"):
            print(f"--platform takes cpu or gpu, not {argv[1]!r}",
                  file=sys.stderr)
            return 2
        import jax

        jax.config.update("jax_platforms", argv[1])
        argv = argv[2:]
    from tpuslam.core.device import configure_compile_cache

    configure_compile_cache()
    if argv and argv[0] == "--serve":
        return run_serve()
    if argv and argv[0] == "--test-set":
        return run_test_set_cli(argv[1:])
    return run_config(argv)


if __name__ == "__main__":
    sys.exit(main())

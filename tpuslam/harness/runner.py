"""Benchmark runner — the reference's ``TestRunner``
(``testrunner.h:10-33``, ``testrunner.cpp:7-90``) with the identical CSV
schema ``test-no;cloud-size;rotation;translation;time(ms);iterations;error``
(``testrunner.cpp:14``) for drop-in comparability with its published plots,
plus ``run_test_set`` (``RunTestSet``, ``testutils.cpp:64-88``) writing
``<name>-<method>.csv`` per method."""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

from tpuslam.algorithms.registry import SlamFunc, run_with_configuration
from tpuslam.config.configuration import ComputationMethod, Configuration
from tpuslam.data.synthesis import get_clouds_from_config, transform_cloud
from tpuslam.harness.timer import Timer


class TestRunner:
    __test__ = False  # not a pytest class despite the reference-parity name

    def __init__(
        self,
        compute_function: Optional[SlamFunc] = None,
        output_file: str = "",
        jsonl_path: str = "",
        warmup: bool = False,
        resume: bool = False,
    ):
        # warmup runs each test's compute once untimed before the timed
        # call, so jit compilation never lands in ``time(ms)`` (the
        # reference's CUDA kernels are precompiled; folding a one-off
        # 200 s XLA compile into row 0 made that row garbage)
        self.warmup = warmup
        self.compute_function = compute_function or (
            lambda before, after, config: run_with_configuration(
                before, after, config
            )
        )
        self.output_file = output_file
        self.tests: List[Configuration] = []
        self.current_test_index = 0
        self.rows: List[str] = []
        self.run_logger = None
        if jsonl_path:
            from tpuslam.harness.logging import RunLogger

            self.run_logger = RunLogger(jsonl_path)
        # resume: if the CSV already holds completed rows (an interrupted
        # benchmark run), append after them instead of truncating, and
        # expose the count as ``start_index`` so the caller can skip the
        # already-measured configurations
        self.start_index = 0
        self._fh = None
        if output_file:
            if resume and os.path.exists(output_file):
                with open(output_file) as fh:
                    done = [ln for ln in fh if ln.strip()][1:]
                self.start_index = len(done)
            if self.start_index:
                self._fh = open(output_file, "a")
            else:
                self._fh = open(output_file, "w")
                self._write(
                    "test-no;cloud-size;rotation;translation;"
                    "time(ms);iterations;error\n"
                )

    def _write(self, line: str) -> None:
        self.rows.append(line)
        if self._fh is not None:
            self._fh.write(line)
            self._fh.flush()

    def add_test(self, configuration: Configuration) -> None:
        self.tests.append(configuration)

    def run_all(self) -> None:
        self.current_test_index = self.start_index
        pending, self.tests = self.tests, []
        for test in pending:
            print("=" * 66)
            print(f"Running test {self.current_test_index}")
            print("=" * 66)
            self.run_single(test)
            print("=" * 66)
            print("Test ended")
            print("=" * 66 + "\n")
            self.current_test_index += 1

    def run_single(self, configuration: Configuration) -> None:
        before, after, _ = get_clouds_from_config(configuration)

        if self.warmup:
            # same shapes, so the jit cache hit covers the timed run
            self.compute_function(before, after, configuration)

        timer = Timer()
        result = timer.stage_timed_call(
            "test",
            lambda: self.compute_function(before, after, configuration),
        )
        rotation, translation, iterations, error = result
        timer.print_results()
        print(f"Error: {error:f}")

        if self.run_logger is not None:
            from tpuslam.harness.logging import result_record

            self.run_logger.log(
                result_record(
                    configuration, rotation, translation, iterations, error,
                    cloud_sizes=(len(before), len(after)),
                    timings_ms={"test": timer.get_stage_time("test")},
                )
            )

        tp = configuration.transformation_parameters
        self._write(
            f"{self.current_test_index};{len(before)};"
            f"{tp[0] if tp else -1.0:f};{tp[1] if tp else -1.0:f};"
            f"{timer.get_stage_time('test')};{iterations};{error:f}\n"
        )

        if configuration.show_visualisation:
            from tpuslam.viz.view import show_registration

            transformed = transform_cloud(before, rotation, translation)
            show_registration(before, after, transformed)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def run_test_set(
    acquire: Callable[[ComputationMethod], Sequence[Configuration]],
    name: str,
    methods: Sequence[ComputationMethod] = tuple(ComputationMethod),
    compute_function: Optional[SlamFunc] = None,
    output_dir: str = ".",
    warmup: bool = False,
    resume: bool = False,
) -> List[str]:
    """``Tests::RunTestSet`` (``testutils.cpp:64-88``): one CSV per method,
    named ``<name>-<method>.csv``.  Returns the written file paths.

    ``resume=True`` continues an interrupted run: rows already present in
    the output CSV are kept and their configurations skipped."""
    written = []
    os.makedirs(output_dir, exist_ok=True)
    for method in methods:
        out = os.path.join(output_dir, f"{name}-{method.value}.csv")
        runner = TestRunner(compute_function, out, warmup=warmup,
                            resume=resume)
        for config in list(acquire(method))[runner.start_index:]:
            runner.add_test(config)
        runner.run_all()
        runner.close()
        written.append(out)
    return written

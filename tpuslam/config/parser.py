"""JSON config parser reproducing the reference's CLI + JSON contract.

CLI contract (``configparser.cpp:11-39``): zero args load
``config/default.json``; one arg loads that path if it exists, otherwise the
default; more args print usage and load the default.

Every key, default and error behavior follows ``configparser.cpp:41-266``.
Parse failures set ``correct = False`` (the caller aborts,
``mainwrapper.cpp:8-12``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np

from tpuslam.config.configuration import (
    ApproximationType,
    ComputationMethod,
    Configuration,
    ExecutionPolicy,
)

DEFAULT_PATH = "config/default.json"


class ConfigParser:
    def __init__(self, argv: list[str]):
        """``argv`` excludes the program name (i.e. ``sys.argv[1:]``)."""
        self.config = Configuration()
        self.correct = True
        if len(argv) == 0:
            print(f"No config passed, loading: {DEFAULT_PATH}")
            self.load_config_from_file(DEFAULT_PATH)
        elif len(argv) == 1:
            path = argv[0]
            if os.path.exists(path):
                print(f"Loading config from: {path}")
                self.load_config_from_file(path)
            else:
                print(f"File: {path} does not exist, loading default config")
                self.load_config_from_file(DEFAULT_PATH)
        else:
            print("Usage: tpuslam (config_path)")
            print("Loading default config")
            self.load_config_from_file(DEFAULT_PATH)

    @classmethod
    def from_dict(cls, parsed: dict) -> "ConfigParser":
        """Parser over an in-memory request dict (same key contract as a
        config file) — the serve-mode entry (``cli.run_serve``)."""
        self = cls.__new__(cls)
        self.config = Configuration()
        self.correct = True
        try:
            self.parse_dict(parsed)
        except Exception as exc:  # noqa: BLE001 — report, don't crash
            print(f"Parsing error: {exc}")
            self.correct = False
        return self

    def is_correct(self) -> bool:
        return self.correct

    def get_configuration(self) -> Configuration:
        return self.config

    # -- parsing ----------------------------------------------------------

    def load_config_from_file(self, path: str) -> None:
        try:
            with open(path, "r") as fh:
                parsed = json.load(fh)
            self._parse_method(parsed)
            self._parse_cloud_paths(parsed)
            self._parse_execution_policy(parsed)
            self._parse_transformation(parsed)
            self._parse_transformation_parameters(parsed)
            self._parse_additional_parameters(parsed)
            self._validate()
        except Exception as ex:  # noqa: BLE001 — mirrors catch(...) abort path
            print(f"Parsing error: {ex}")
            self.correct = False

    def parse_dict(self, parsed: dict) -> None:
        """Parse an in-memory dict (used by tests and the harness)."""
        self._parse_method(parsed)
        self._parse_cloud_paths(parsed)
        self._parse_execution_policy(parsed)
        self._parse_transformation(parsed)
        self._parse_transformation_parameters(parsed)
        self._parse_additional_parameters(parsed)
        self._validate()

    def _required(self, parsed: dict, key: str) -> Optional[Any]:
        if key not in parsed:
            print(f"Parsing error: param {key} is required")
            self.correct = False
            return None
        return parsed[key]

    @staticmethod
    def _optional(parsed: dict, key: str, default: Any = None) -> Any:
        return parsed.get(key, default)

    def _parse_method(self, parsed: dict) -> None:
        method = self._required(parsed, "method")
        if method is None:
            return
        mapping = {
            "icp": ComputationMethod.Icp,
            "nicp": ComputationMethod.NoniterativeIcp,
            "cpd": ComputationMethod.Cpd,
        }
        if method in mapping:
            self.config.computation_method = mapping[method]
        else:
            print(f"Parsing error: Computational method {method} not supported")
            self.correct = False

    def _parse_cloud_paths(self, parsed: dict) -> None:
        before = self._required(parsed, "before-path")
        after = self._required(parsed, "after-path")
        if before is None or after is None:
            return
        self.config.before_path = before
        self.config.after_path = after

    def _parse_execution_policy(self, parsed: dict) -> None:
        policy = self._optional(parsed, "policy")
        if policy is None:
            return
        mapping = {
            "parallel": ExecutionPolicy.Parallel,
            "sequential": ExecutionPolicy.Sequential,
        }
        if policy in mapping:
            self.config.execution_policy = mapping[policy]
        else:
            # the reference prints "warning" but still flags the config
            # invalid (configparser.cpp:122-125)
            print(f"Parsing warning: Execution policy {policy} not supported")
            self.correct = False

    def _parse_transformation(self, parsed: dict) -> None:
        # scale multiplies the rotation matrix (configparser.cpp:132,157)
        scale = float(self._optional(parsed, "scale", 1.0))
        if "translation" in parsed and "rotation" in parsed:
            translation = parsed["translation"]
            rotation = parsed["rotation"]
            if len(translation) != 3 or len(rotation) != 9:
                print("Parsing error: Wrong translation or rotation size")
                self.correct = False
                return
            try:
                # rotation is a row-major 9-array: element (row r, col c) at
                # index r*3+c (configparser.cpp:148-151 fills glm [col][row])
                rot = np.asarray(rotation, dtype=np.float32).reshape(3, 3)
                trans = np.asarray(translation, dtype=np.float32)
                self.config.transformation = (scale * rot, trans)
            except Exception:  # noqa: BLE001
                print(
                    "Parsing error: Error parsing translation or rotation parameter"
                )
                self.correct = False

    def _parse_transformation_parameters(self, parsed: dict) -> None:
        # parser reads "rotation-range" even though the schema/docs say
        # "angle-range" (configparser.cpp:170 vs config/schema.json)
        if "translation-range" in parsed and "rotation-range" in parsed:
            try:
                tr = float(parsed["translation-range"])
                rr = float(parsed["rotation-range"])
                self.config.transformation_parameters = (rr, tr)
            except Exception:  # noqa: BLE001
                print(
                    "Parsing error: Error parsing translation-range or "
                    "rotation-range parameter"
                )
                self.correct = False

    def _parse_additional_parameters(self, parsed: dict) -> None:
        c = self.config
        opt = self._optional
        c.max_iterations = opt(parsed, "max-iterations")
        c.cloud_before_resize = opt(parsed, "cloud-before-resize")
        c.cloud_after_resize = opt(parsed, "cloud-after-resize")
        c.cloud_spread = opt(parsed, "cloud-spread")
        c.random_seed = opt(parsed, "random-seed")
        c.noise_affected_points_before = opt(parsed, "noise-affected-points-before")
        c.noise_affected_points_after = opt(parsed, "noise-affected-points-after")
        c.show_visualisation = opt(parsed, "show-visualisation", False)
        c.max_distance_squared = float(opt(parsed, "max-distance-squared", 1000.0))

        approx = opt(parsed, "approximation-type")
        mapping = {
            "full": ApproximationType.Full,
            "hybrid": ApproximationType.Hybrid,
            "none": ApproximationType.NONE,
        }
        # unknown strings silently fall back to Hybrid (configparser.cpp:214-230)
        c.approximation_type = mapping.get(approx, ApproximationType.Hybrid)

        c.nicp_batch_size = int(opt(parsed, "nicp-batch-size", 16))
        c.nicp_iterations = int(opt(parsed, "nicp-iterations", 32))
        c.nicp_subcloud_size = int(opt(parsed, "nicp-subcloud-size", 1000))
        c.cpd_weight = float(opt(parsed, "cpd-weight", 0.3))
        c.cpd_const_scale = bool(opt(parsed, "cpd-const-scale", False))
        c.cpd_tolerance = float(opt(parsed, "cpd-tolerance", 1e-3))
        c.convergence_epsilon = float(opt(parsed, "convergence-epsilon", 1e-3))
        c.noise_intensity_before = float(opt(parsed, "noise-intensity-before", 0.1))
        c.noise_intensity_after = float(opt(parsed, "noise-intensity-after", 0.1))
        c.additional_outliers_before = int(opt(parsed, "additional-outliers-before", 0))
        c.additional_outliers_after = int(opt(parsed, "additional-outliers-after", 0))
        c.ratio_of_far_field = float(opt(parsed, "fgt-ratio-of-far-field", 10.0))
        c.order_of_truncation = int(opt(parsed, "fgt-order-of-truncation", 8))
        # extension key (not in the reference): force the CPD full/
        # hybrid fast-phase arm — true = device FGT, false = exact
        # blocked kernel; absent = auto (the size crossover,
        # see tpuslam.algorithms.cpd module doc)
        _fgt = opt(parsed, "cpd-use-fgt", None)
        c.cpd_use_fgt = None if _fgt is None else bool(_fgt)
        # extension key: centroid-difference EM start for CPD (rescues
        # free-scale registration at large translations)
        c.cpd_centroid_init = bool(opt(parsed, "cpd-centroid-init", False))
        # extension key: NICP pre-alignment for ICP (large-motion rescue;
        # see tpuslam.algorithms.icp.icp_register_prealigned)
        c.icp_prealign = bool(opt(parsed, "icp-prealign", False))
        # extension key: write the transformed cloud after registration
        sop = opt(parsed, "save-output-path", None)
        c.save_output_path = str(sop) if sop is not None else None
        # extension key: NICP degenerate-spectrum candidate widening
        # (None/absent = auto eigengap pre-pass, 0 = off, N = N angles)
        ndw = opt(parsed, "nicp-degenerate-widening", None)
        c.nicp_degenerate_widening = (
            int(ndw) if ndw is not None else None
        )

    def _validate(self) -> None:
        if self.config.transformation is None and (
            self.config.transformation_parameters is None
        ):
            print(
                "Parsing error: transformation or transformation parameters "
                "have to be provided"
            )
            self.correct = False

"""Result metadata accumulator (API-parity port of
``ccvm_simulators/metadata.py``): a copy of ``ccvm_tpu/metadata.py``, which
imports no JAX, kept here so the port imports nothing of the JAX package.
The JSON schema is identical, so the plotting pipeline (the port's and the
JAX package's) and any reference tooling can consume these files."""

from __future__ import annotations

import json
import logging
import os

logger = logging.getLogger(__name__)


class Metadata:
    """Define the metadata class (reference ``metadata.py:5-61``)."""

    def __init__(self, device):
        self.result_metadata = []
        self.metadata_dict = {
            "device": device,
            "result_metadata": self.result_metadata,
        }

    def add_to_result_metadata(self, result_dict):
        """Add a result dict to the result metadata list."""
        self.result_metadata.append(result_dict)
        self.metadata_dict["result_metadata"] = self.result_metadata

    def save_metadata_to_file(self, file_dir="./metadata", file_name="metadata"):
        """Save the metadata dict to ``<file_dir>/<file_name>.json``.

        Returns:
            str: File path of the metadata file.
        """
        try:
            if not os.path.isdir(file_dir):
                os.makedirs(file_dir)
                logger.info("Creating metadata folder: %s", file_dir)
        except Exception as e:
            raise Exception(f"Failed to create the folder path: {e}")

        metadata_file_path = f"{file_dir}/{file_name}.json"
        try:
            with open(metadata_file_path, "w") as outfile:
                json.dump(self.metadata_dict, outfile)
                logger.info("Saved metadata to %s", metadata_file_path)
                return metadata_file_path
        except Exception as e:
            raise Exception("Error saving metadata to file: " + str(e))

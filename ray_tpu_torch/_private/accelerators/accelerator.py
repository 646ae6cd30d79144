"""Pluggable accelerator manager interface.

TPU-native rebuild of the reference's accelerator framework
(reference: python/ray/_private/accelerators/accelerator.py:5-141 — the ABC
every vendor implements: resource name, autodetect, visible-device env
handling, extra resources, node labels).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class AcceleratorManager:
    """One subclass per accelerator family."""

    @staticmethod
    def get_resource_name() -> str:
        raise NotImplementedError

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> Optional[str]:
        return None

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        return 0

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        return None

    @staticmethod
    def validate_resource_request_quantity(quantity: float) -> tuple:
        """(valid, error_message)."""
        return (True, None)

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        return None

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        pass

    @staticmethod
    def get_current_node_additional_resources() -> Dict[str, float]:
        return {}

    @staticmethod
    def get_current_node_labels() -> Dict[str, str]:
        return {}

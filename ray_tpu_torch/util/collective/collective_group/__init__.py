"""Collective groups: the store backend and the NCCL backend."""

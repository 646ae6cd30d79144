"""Collective communication of the port: so far the gradient codec
(``compression``); the NCCL group is ROADMAP A10."""

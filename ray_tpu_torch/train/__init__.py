"""Training runtime of the port: so far the step snapshots
(``_internal/snapshot.py``); sessions and trainers are ROADMAP A12/A16."""

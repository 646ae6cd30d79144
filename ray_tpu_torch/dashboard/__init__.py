"""Per-node stats agent (``agent.NodeStatsCollector``, which every raylet
builds).  The dashboard head (the HTTP API over cluster state) is not
ported yet: ROADMAP A16."""

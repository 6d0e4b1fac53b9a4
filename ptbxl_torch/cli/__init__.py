"""Command-line entry points of the port (``python -m ptbxl_torch.cli.<name>``).

Each mirrors a numbered script of ``scripts/``: the same arguments, prints,
output paths, CSV and checkpoint names, plus ``--device`` (default ``cuda``;
``cpu`` runs on the host).
"""

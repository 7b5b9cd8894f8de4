"""Runnable examples of the port (counterparts of the repository's
``examples/``), each run as a module:

    python -m obs_color_monitor_tpu_torch.examples.<name> [--device cpu] ...

``multistream_serving`` (batch data-parallel over a mesh),
``multihost_distributed`` (ranks of a torch.distributed group, simulated
on the CPU with ``--simulate``), ``driver_pipeline`` (a PipelineDriver
feeding a Dock, retrying rejected pushes), ``interactive_roi_drag`` (a
dragged ROI served by one captured graph) and ``p010_wire_ingest`` (P010
wire planes decoded on the device).  Each runs on the card by default,
takes ``--device cpu``, and prints markers that show its path ran.
"""

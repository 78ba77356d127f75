"""Fault tolerance: checkpoints with async write, atomic publish and an
integrity manifest (the on-disk format of :mod:`repro.ft.checkpoint`),
heartbeat-based failure detection, straggler detection and crash-consistent
restart."""

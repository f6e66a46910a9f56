"""Host-side tools of the design runner: Chothia renumbering and DockQ."""

"""Per-subject exports of the port."""

"""Reference-named preprocessing entry points.

``gpsig/preprocessing.py`` (SURVEY.md §2.1) — the names match the core
module exactly, so this is a re-export: ``tabulate_list_of_sequences``
(pad ragged sequences by repeating the last observation — the
masking-by-construction trick), ``add_time_to_list`` /
``add_time_to_table``, and the channel scaler.
"""

from gpsig.data.preprocessing import (  # noqa: F401
    SequenceScaler,
    add_time_to_list,
    add_time_to_table,
    flatten_sequences,
    tabulate_list_of_sequences,
)

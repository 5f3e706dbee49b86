"""Analysis tools of the port: `check_counters`, the counters gate."""

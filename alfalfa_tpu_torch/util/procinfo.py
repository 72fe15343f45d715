"""Process memory usage from /proc/self/statm (util/procinfo.cc:35)."""
import os

_PAGE = os.sysconf("SC_PAGE_SIZE")


def memory_usage():
    """Resident set size as a human-readable string."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return f"{rss_pages * _PAGE / (1 << 20):.1f} MiB"
    except OSError:
        return "n/a"

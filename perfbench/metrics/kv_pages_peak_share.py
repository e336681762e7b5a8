"""The KV arena's peak pages in use over its allocatable pages, the
program's own counters (``KVArena.alloc_peak`` / ``total_pages``) of the
window's arena."""


def read(run):
    if not run.arena or not run.arena["total_pages"]:
        return None
    return 100.0 * run.arena["alloc_peak"] / run.arena["total_pages"]

"""Seconds from a window save's ``save()`` call to its handle reporting
the durable COMMIT, the mean over the window's saves: how stale the
newest recovery point is. None where a save never committed."""


def read(rec):
    commits = rec.get("commit_s") or []
    if not commits or None in commits:
        return None
    return sum(commits) / len(commits)

"""Share of the K/V pool's pages held by requests, in %, sampled after
every step of the window and averaged (the allocator's free count; a
request holds its prompt's and its output's pages from admission)."""


def read(run):
    pages = run.phase.pages
    if not pages:
        return None
    return 100.0 * sum(pages) / len(pages)

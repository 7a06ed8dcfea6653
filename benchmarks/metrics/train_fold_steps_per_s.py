"""Every fold's optimizer step completed in the window, over the window's
wall time (from the first call's start to the last call's synchronised
end); training cells only."""


def read(rec):
    if rec["unit"] != "fold-steps":
        return None
    return rec["window"]["work"] / rec["window"]["seconds"]

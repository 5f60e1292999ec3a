"""inserts_per_frame (program counter): frames whose info row says
map_inserted (KN and the voxel-map insert ran), over the frames of the
sequences that report them."""


def read(ctx):
    recs = [r for r in ctx.records if "inserts" in r]
    if not recs:
        return None
    return sum(r["inserts"] for r in recs) / sum(r["frames"] for r in recs)

"""How unevenly the text encoder's router loads its experts: in each MoE
layer the busiest expert's tokens over the mean expert's, over the
card-only traced pass (the program's expert-load counter), averaged over
the layers. 1 is an even load."""


def read(s: dict):
    m = s.get("encoder")
    if not m:
        return None
    shares = [max(row) * len(row) / sum(row) for row in m["load"] if sum(row)]
    return sum(shares) / len(shares) if shares else None

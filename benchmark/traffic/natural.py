"""Seeded camera-like video, made on the device in a few large calls.

A torch rewrite of the pieces of the repository's natural-clip generator
(``tests/fixtures/gen_natural.py``: multi-octave value noise, a camera
that pans, zooms and shakes over a larger world, soft-edged moving
objects, a scene cut, film grain), so that 4K frames take milliseconds.
The parameters come from a cell's traffic file; the seed draws only the
textures, the shake and the grain, never a size, a speed or the frame of
the cut, so every seed asks the same amount of work of the codec.

``clip(params, width, height, frames, seed, device)`` returns a list of
(y, u, v) uint8 numpy planes (4:2:0).  It imports nothing of the program.
"""
import math

import torch
import torch.nn.functional as F


def _value_noise(gen, h, w, octaves, base, persistence, device):
    """Multi-octave value noise in [0, 1]: bilinear upsamplings of random
    grids, summed with falling amplitude."""
    out = torch.zeros((1, 1, h, w), device=device)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh, gw = min(h, base * 2 ** o), min(w, base * 2 ** o)
        grid = torch.rand((1, 1, gh, gw), generator=gen, device=device)
        out += amp * F.interpolate(grid, size=(h, w), mode="bilinear",
                                   align_corners=True)
        total += amp
        amp *= persistence
    return out[0, 0] / total


def _world(gen, h, w, octaves, device, structures=6):
    """A luma and two chroma planes (float 0..255) the camera moves over:
    smooth texture, a horizon gradient and hard-edged blocks."""
    y = _value_noise(gen, h, w, octaves, 8, 0.68, device) * 235 + 10
    y += torch.linspace(-30, 30, h, device=device)[:, None]
    r = torch.rand((structures, 5), generator=gen, device=device).tolist()
    for r0, c0, rh, rw, dv in r:
        r0, c0 = int(r0 * (h - 24)), int(c0 * (w - 24))
        rh, rw = 12 + int(rh * h / 4), 12 + int(rw * w / 4)
        y[r0:r0 + rh, c0:c0 + rw] += dv * 100 - 50
    u = _value_noise(gen, h // 2, w // 2, 3, 8, 0.68, device) * 90 + 85
    v = _value_noise(gen, h // 2, w // 2, 3, 8, 0.68, device) * 90 + 85
    return y.clamp(0, 255), u.clamp(16, 240), v.clamp(16, 240)


def _sample(plane, oy, ox, h, w, zoom):
    """(n, h, w) bilinear windows of ``plane`` at offsets (oy, ox) (n,)
    and zoom (n,), with coordinates clamped inside the plane."""
    H, W = plane.shape
    ar_y = torch.arange(h, device=plane.device, dtype=torch.float32)
    ar_x = torch.arange(w, device=plane.device, dtype=torch.float32)
    ys = (oy[:, None] + ar_y[None] * zoom[:, None]).clamp(0, H - 1.001)
    xs = (ox[:, None] + ar_x[None] * zoom[:, None]).clamp(0, W - 1.001)
    gy = ys / (H - 1) * 2 - 1
    gx = xs / (W - 1) * 2 - 1
    grid = torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]),
                       dim=-1)
    src = plane[None, None].expand(len(oy), 1, H, W)
    return F.grid_sample(src, grid, mode="bilinear", align_corners=True)[:, 0]


def _sprite(gen, size, device):
    yy, xx = torch.meshgrid(torch.arange(size, device=device),
                            torch.arange(size, device=device), indexing="ij")
    c = (size - 1) / 2
    d = torch.sqrt(((yy - c) / (size * 0.45)) ** 2 + ((xx - c) / (size * 0.38)) ** 2)
    alpha = (1.25 - d).clamp(0, 1) ** 1.5
    tex = _value_noise(gen, size, size, 3, 8, 0.68, device) * 120 + 80
    return tex, alpha


def clip(params, width, height, frames, seed, device, batch=8):
    """``frames`` frames of the scene ``params`` describes:

    pan        [dy, dx] pixels a frame
    zoom_rate  zoom change a frame (0: none)
    shake      largest jitter of the camera, pixels (uniform, from the seed)
    grain      standard deviation of the luma grain
    cut_at     frames at which the scene cuts to a new world (list)
    objects    list of {size, amplitude, period}: soft blobs that move on
               an ellipse in front of the camera (a caller's head and hands)
    octaves    texture octaves of the world
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    pan = params.get("pan", [0.0, 0.0])
    zoom_rate = float(params.get("zoom_rate", 0.0))
    shake = float(params.get("shake", 0.0))
    grain = float(params.get("grain", 0.0))
    cuts = sorted(params.get("cut_at", []))
    octaves = int(params.get("octaves", 8))
    margin = int(max(abs(pan[0]), abs(pan[1])) * frames
                 + abs(zoom_rate) * frames * max(width, height) + 4 * shake + 8)
    wh, ww = height + 2 * margin, width + 2 * margin
    worlds = [_world(gen, wh, ww, octaves, device) for _ in range(len(cuts) + 1)]
    sprites = [(_sprite(gen, int(o["size"]), device), o) for o in
               params.get("objects", [])]
    phase = torch.rand((max(1, len(sprites)),), generator=gen,
                       device=device).tolist()

    n = torch.arange(frames, device=device, dtype=torch.float32)
    jitter = (torch.rand((2, frames), generator=gen, device=device) * 2 - 1) * shake
    oy = margin + pan[0] * n + jitter[0]
    ox = margin + pan[1] * n + jitter[1]
    zoom = 1.0 + zoom_rate * n
    scene = torch.tensor([sum(f >= c for c in cuts) for f in range(frames)])
    out = []
    for s in range(0, frames, batch):
        e = min(frames, s + batch)
        idx = torch.arange(s, e)
        planes = []
        for k, (ph, pw, scale) in enumerate(((height, width, 1),
                                             (height // 2, width // 2, 2))
                                            + ((height // 2, width // 2, 2),)):
            got = torch.empty((e - s, ph, pw), device=device)
            for w_i, world in enumerate(worlds):
                sel = (scene[idx] == w_i).nonzero().flatten()
                if len(sel):
                    got[sel] = _sample(world[k], oy[s + sel] / scale,
                                       ox[s + sel] / scale, ph, pw,
                                       zoom[s + sel])
            planes.append(got)
        y = planes[0]
        for ((tex, alpha), o), p0 in zip(sprites, phase):
            size = tex.shape[0]
            for j, f in enumerate(range(s, e)):
                t = 2 * math.pi * (f / float(o["period"]) + p0)
                cy = height / 2 + o["amplitude"][0] * math.sin(t) - size / 2
                cx = width / 2 + o["amplitude"][1] * math.cos(t) - size / 2
                r0, c0 = int(cy), int(cx)
                r1, c1 = max(0, r0), max(0, c0)
                r2, c2 = min(height, r0 + size), min(width, c0 + size)
                if r2 > r1 and c2 > c1:
                    a = alpha[r1 - r0:r2 - r0, c1 - c0:c2 - c0]
                    tx = tex[r1 - r0:r2 - r0, c1 - c0:c2 - c0]
                    y[j, r1:r2, c1:c2] = y[j, r1:r2, c1:c2] * (1 - a) + tx * a
        if grain:
            y = y + torch.randn(y.shape, generator=gen, device=device) * grain
        planes[0] = y
        host = [p.round().clamp(0, 255).to(torch.uint8).cpu().numpy() for p in planes]
        out.extend(zip(*host))
    return out

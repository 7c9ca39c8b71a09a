"""Training prompt generation: textual-inversion templates, compositional
suffix sampling, and the 4-type prompt set.

Port of `adaprompt_tpu/data/prompts.py`, its own copy: the same pools, the
same slot structure and the same draws from `random.Random`, so that one
seed gives the same strings in both packages.
"""

from __future__ import annotations

import random

# Textual-inversion templates (Gal et al. 2022; personalized.py:24-106)
IMAGENET_TEMPLATES_SMALL = [
    "a photo of a {}", "a rendering of a {}", "a cropped photo of the {}",
    "the photo of a {}", "a photo of a clean {}", "a photo of a dirty {}",
    "a dark photo of the {}", "a photo of my {}", "a photo of the cool {}",
    "a close-up photo of a {}", "a bright photo of the {}",
    "a cropped photo of a {}", "a photo of the {}", "a good photo of the {}",
    "a photo of one {}", "a close-up photo of the {}", "a rendition of the {}",
    "a photo of the clean {}", "a rendition of a {}", "a photo of a nice {}",
    "a good photo of a {}", "a photo of the nice {}", "a photo of the small {}",
    "a photo of the weird {}", "a photo of the large {}", "a photo of a cool {}",
    "a photo of a small {}",
    "an illustration of a {}", "an illustration of a clean {}",
    "an illustration of a dirty {}", "an illustration of my {}",
    "an illustration of the cool {}", "an illustration of the {}",
    "an illustration of one {}", "an illustration of the clean {}",
    "an illustration of a nice {}", "an illustration of the nice {}",
    "an illustration of the small {}", "an illustration of the weird {}",
    "an illustration of the large {}", "an illustration of a cool {}",
    "an illustration of a small {}",
    "a depiction of a {}", "a depiction of a clean {}",
    "a depiction of a dirty {}", "a depiction of my {}",
    "a depiction of the cool {}", "a depiction of the {}",
    "a depiction of one {}", "a depiction of the clean {}",
    "a depiction of a nice {}", "a depiction of the nice {}",
    "a depiction of the small {}", "a depiction of the weird {}",
    "a depiction of the large {}", "a depiction of a cool {}",
    "a depiction of a small {}",
]

# Composition fragment pools (role of all_composition_regexs etc.)
ACTIONS_ANIMAL = [
    "sitting on a chair", "running in a field", "jumping over a fence",
    "swimming in a lake", "sleeping on a sofa", "dancing on a stage",
    "riding a bicycle", "playing a guitar", "reading a book",
    "drinking a cup of coffee", "cooking in a kitchen", "walking on a street",
    "climbing a mountain", "standing in the rain", "waving at the camera",
    "holding a bouquet of flowers", "wearing a crown", "doing yoga in a park",
    "painting on a canvas", "flying a kite on a hill",
]
ACTIONS_OBJECT = [
    "on a table", "on a chair", "in a basket", "on a shelf", "on the grass",
    "next to a window", "under a tree", "on a desk", "in a garden",
    "on a bench", "beside a lamp", "in front of a fireplace",
]
LOCATIONS = [
    "in a park", "on a beach", "in a forest", "in a city square",
    "on a rooftop", "in a meadow", "at a market", "in a museum",
    "by a river", "in the desert", "on a boat", "in a cafe",
]
COEXIST_OBJECTS = [
    "dog", "cat", "bird", "bicycle", "umbrella", "balloon", "lantern",
    "guitar", "teddy bear", "pumpkin",
]
MODIFIERS = [
    "highly detailed", "sharp focus", "vivid colors", "soft shadows",
    "elegant", "majestic", "whimsical", "dramatic", "serene", "vibrant",
    "intricate", "minimalist", "surreal", "dreamy",
]
STYLES = [
    "impressionist", "watercolor", "oil painting", "anime", "pixel art",
    "comic book", "art nouveau", "baroque", "cyberpunk", "steampunk",
    "pop art", "ukiyo-e",
]
ART_BY = [
    "claude monet", "vincent van gogh", "studio ghibli", "norman rockwell",
    "alphonse mucha", "katsushika hokusai", "rembrandt", "gustav klimt",
]
BACKGROUNDS = [
    "a beach", "a park", "a library", "a city", "a mountain",
    "a blue house", "a wheat field", "the Eiffel Tower", "a jungle",
    "the snow", "a cobblestone street", "underwater", "pink fabric",
    "a wooden floor", "a mirror", "a crowded sidewalk", "a dirt road",
    "a white rug", "a concert", "a theme park",
]
TIMES = [
    "at sunrise", "at noon", "at sunset", "at night", "in spring",
    "in summer", "in autumn", "in winter", "during a storm", "on a foggy morning",
]
LIGHTS = [
    "soft lighting", "dramatic lighting", "neon lights", "candlelight",
    "golden hour light", "studio lighting", "moonlight", "volumetric lighting",
]


def sample_compositions(n: int, subj_type: str = "animal",
                        is_training: bool = False, rng: random.Random | None = None):
    """Random compositional prompt suffixes (compositions.py:129-237)."""
    rng = rng or random
    assert subj_type in ("animal", "object")
    actions = ACTIONS_ANIMAL if subj_type == "animal" else ACTIONS_OBJECT
    # probabilities from the reference: training favors plain prompts
    p_opt = 0.25 if is_training else 0.7
    p_bg = 0.6 if is_training else 0.7

    def maybe(pool, prefix, joiner=", ", p=p_opt, max_n=2):
        if rng.random() >= p:
            return ""
        k = rng.randint(1, max_n)
        return prefix + joiner.join(rng.sample(pool, k))

    out = []
    for _ in range(n):
        action = rng.choice(actions)
        obj2 = ""
        if subj_type == "animal" and rng.random() < 0.3:
            obj2 = ", a " + rng.choice(COEXIST_OBJECTS) + " " + rng.choice(LOCATIONS)
        style = maybe(STYLES, ", in ", " and ")
        if style:
            style += " style"
        modifier = maybe(MODIFIERS, ", ", ", ", max_n=3)
        art_by = maybe(ART_BY, ", art by ", " and ", max_n=3)
        background = (", with " + rng.choice(BACKGROUNDS) + " as background") \
            if rng.random() < p_bg else ""
        time = (", " + rng.choice(TIMES)) if rng.random() < p_opt else ""
        light = ", with " + rng.choice(LIGHTS)  # always on (compositions.py:219)
        if is_training:
            comp = f"{action}{modifier}{time}{style}{background}{art_by}{light}{obj2}"
        else:
            image = ", " + rng.choice(["photo", "drawing", "illustration", "picture"])
            comp = f"{modifier}{time}{style}{image} of z {action}{background}{art_by}{light}{obj2}"
            comp = comp.removeprefix(", ")
        out.append(comp)
    return out


def generate_prompt_set(subject_string: str, cls_delta_string: str,
                        background_string: str | None = None,
                        cls_bg_delta_string: str | None = None,
                        num_vectors_per_subj_token: int = 1,
                        num_vectors_per_bg_token: int = 1,
                        broad_class: int = 1, is_animal: bool = True,
                        num_compositions_per_image: int = 1,
                        rng: random.Random | None = None) -> dict:
    """The 4-type prompt set {subj,cls} x {single,comp} (+_fp/_bg variants),
    mirroring PersonalizedBase.generate_prompts (personalized.py:870-981)."""
    rng = rng or random
    if num_vectors_per_subj_token > 1:
        subject_string += ", " * (num_vectors_per_subj_token - 1)
        cls_delta_string += ", " * (num_vectors_per_subj_token - 1)
    if background_string is not None and num_vectors_per_bg_token > 1:
        background_string += ", " * (num_vectors_per_bg_token - 1)
        cls_bg_delta_string += ", " * (num_vectors_per_bg_token - 1)

    template = rng.choice(IMAGENET_TEMPLATES_SMALL)
    bg_suffix = f" with background {background_string}" if background_string else ""
    cls_bg_suffix = f" with background {cls_bg_delta_string}" if cls_bg_delta_string else ""

    comps = sample_compositions(num_compositions_per_image,
                                "animal" if is_animal else "object",
                                is_training=True, rng=rng)

    ex = {
        "caption": template.format(subject_string),
        "caption_bg": template.format(subject_string + bg_suffix),
        "subj_prompt_single": template.format(subject_string),
        "cls_prompt_single": template.format(cls_delta_string),
        "subj_prompt_comp": "|".join(template.format(subject_string) + " " + c for c in comps),
        "cls_prompt_comp": "|".join(template.format(cls_delta_string) + " " + c for c in comps),
    }
    if bg_suffix:
        ex["subj_prompt_single_bg"] = template.format(subject_string + bg_suffix)
        ex["cls_prompt_single_bg"] = template.format(cls_delta_string + cls_bg_suffix)
        ex["subj_prompt_comp_bg"] = "|".join(
            template.format(subject_string + bg_suffix) + " " + c for c in comps)
        ex["cls_prompt_comp_bg"] = "|".join(
            template.format(cls_delta_string + cls_bg_suffix) + " " + c for c in comps)
    if broad_class == 1:
        fp = "a face portrait of a {}"
        ex["subj_prompt_single_fp"] = fp.format(subject_string)
        ex["cls_prompt_single_fp"] = fp.format(cls_delta_string)
        ex["subj_prompt_comp_fp"] = "|".join(fp.format(subject_string) + " " + c for c in comps)
        ex["cls_prompt_comp_fp"] = "|".join(fp.format(cls_delta_string) + " " + c for c in comps)
        if bg_suffix:
            ex["subj_prompt_single_fp_bg"] = fp.format(subject_string + bg_suffix)
            ex["cls_prompt_single_fp_bg"] = fp.format(cls_delta_string + cls_bg_suffix)
            ex["subj_prompt_comp_fp_bg"] = "|".join(
                fp.format(subject_string + bg_suffix) + " " + c for c in comps)
            ex["cls_prompt_comp_fp_bg"] = "|".join(
                fp.format(cls_delta_string + cls_bg_suffix) + " " + c for c in comps)
    return ex

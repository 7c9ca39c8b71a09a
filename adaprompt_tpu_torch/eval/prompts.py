"""Evaluation prompt sets and list formatting.

The port's own copy of `adaprompt_tpu/eval/prompts.py` (the reference's
format_prompt_list, evaluation/eval_utils.py). The object/animal lists are
the public DreamBooth benchmark prompts (Ruiz et al., CVPR 2023); the
community list holds stylistically rich face prompts and can be replaced
from a text file through `load_prompt_file`.
"""

from __future__ import annotations

# DreamBooth benchmark — object subjects
OBJECT_PROMPT_LIST = [
    "a {0}{1}{2} in the jungle",
    "a {0}{1}{2} in the snow",
    "a {0}{1}{2} on the beach",
    "a {0}{1}{2} on a cobblestone street",
    "a {0}{1}{2} on top of pink fabric",
    "a {0}{1}{2} on top of a wooden floor",
    "a {0}{1}{2} with a city in the background",
    "a {0}{1}{2} with a mountain in the background",
    "a {0}{1}{2} with a blue house in the background",
    "a {0}{1}{2} on top of a purple rug in a forest",
    "a {0}{1}{2} with a wheat field in the background",
    "a {0}{1}{2} with a tree and autumn leaves in the background",
    "a {0}{1}{2} with the Eiffel Tower in the background",
    "a {0}{1}{2} floating on top of water",
    "a {0}{1}{2} floating in an ocean of milk",
    "a {0}{1}{2} on top of green grass with sunflowers around it",
    "a {0}{1}{2} on top of a mirror",
    "a {0}{1}{2} on top of the sidewalk in a crowded street",
    "a {0}{1}{2} on top of a dirt road",
    "a {0}{1}{2} on top of a white rug",
    "a {0}red {1}{2}",
    "a {0}purple {1}{2}",
    "a {0}shiny {1}{2}",
    "a {0}wet {1}{2}",
    "a {0}cube shaped {1}{2}",
]

# DreamBooth benchmark — live subjects (humans/animals); the reference drops
# the two floor/rug layouts that misbehave for live subjects
ANIMAL_PROMPT_LIST = [
    "a {0}{1}{2} in the jungle",
    "a {0}{1}{2} in the snow",
    "a {0}{1}{2} on the beach",
    "a {0}{1}{2} on a cobblestone street",
    "a {0}{1}{2} on top of pink fabric",
    "a {0}{1}{2} with a city in the background",
    "a {0}{1}{2} with a mountain in the background",
    "a {0}{1}{2} with a blue house in the background",
    "a {0}{1}{2} wearing a red hat",
    "a {0}{1}{2} wearing a santa hat",
    "a {0}{1}{2} wearing a rainbow scarf",
    "a {0}{1}{2} wearing a black top hat and a monocle",
    "a {0}{1}{2} in a chef outfit",
    "a {0}{1}{2} in a firefighter outfit",
    "a {0}{1}{2} in a police outfit",
    "a {0}{1}{2} wearing pink glasses",
    "a {0}{1}{2} wearing a yellow shirt",
    "a {0}{1}{2} in a purple wizard outfit",
    "a {0}red {1}{2}",
    "a {0}purple {1}{2}",
    "a {0}shiny {1}{2}",
    "a {0}wet {1}{2}",
]

# Stylistically rich "community" face prompts (role of the reference's
# community_prompt_list; extensible/replaceable via load_prompt_file)
COMMUNITY_PROMPT_LIST = [
    "{0} {1}{2} as a medieval knight in ornate armor, castle courtyard, golden hour, cinematic lighting, ultra detailed",
    "{0} {1}{2} scuba diving among coral reefs and tropical fish, underwater photography, sharp focus",
    "{0} {1}{2} drinking a cup of coffee at a parisian cafe, soft morning light",
    "astronaut {0} {1}{2} floating in outer space, earth in the background, detailed spacesuit",
    "{0} {1}{2} as a wizard with staff and robe, fantasy concept art, intricate, volumetric lighting",
    "cyberpunk {0} {1}{2} on a neon-lit street at night, rain reflections, photorealistic",
    "{0} {1}{2} surfing a large wave, action photography, clear face, high shutter speed",
    "oil painting of {0} {1}{2} in renaissance style, chiaroscuro, museum quality",
    "{0} {1}{2} hiking on a mountain ridge at sunrise, wide angle, windswept hair",
    "a marble sculpture of {0} {1}{2}, studio lighting, art photography",
    "{0} {1}{2} as a chef plating a dish in a professional kitchen, shallow depth of field",
    "watercolor illustration of {0} {1}{2} in a flower garden, pastel palette",
    "{0} {1}{2} playing an acoustic guitar by a campfire at dusk",
    "{0} {1}{2} in a superhero costume flying above a city, dynamic pose, comic style",
    "{0} {1}{2} reading a book in a cozy library, warm indoor lighting, detailed",
]


def load_prompt_file(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]


def format_prompt_list(subject_string: str, z_prefix: str = "", z_suffix: str = "",
                       background_string: str = "", class_token: str = "",
                       class_long_token: str = "", broad_class: int = 1,
                       prompt_set_name: str = "all", use_fp_trick: bool = False):
    """-> (prompt_list, class_short_prompt_list, class_long_prompt_list),
    mirroring eval_utils.format_prompt_list semantics: {0}=fp-trick prefix,
    {1}=subject/class token, {2}=suffix+background."""
    if broad_class in (1, 2):
        if prompt_set_name == "community":
            base = COMMUNITY_PROMPT_LIST
        elif prompt_set_name == "dreambench":
            base = ANIMAL_PROMPT_LIST
        elif prompt_set_name == "all":
            base = ANIMAL_PROMPT_LIST + COMMUNITY_PROMPT_LIST
        else:
            raise ValueError(prompt_set_name)
    else:
        base = OBJECT_PROMPT_LIST

    z_suffix = z_suffix + background_string
    if z_prefix and not z_prefix.endswith(" "):
        z_prefix += " "
    subject_string = z_prefix + subject_string
    fp = "face portrait of " if use_fp_trick else ""
    if class_token and class_token in fp:
        class_token = ""
    if class_long_token and class_long_token in fp:
        class_long_token = ""

    prompt_list = [p.format(fp, subject_string, z_suffix) for p in base]
    short_list = [p.format(fp, class_token, background_string) for p in base]
    long_list = [p.format(fp, class_long_token, background_string) for p in base]
    return prompt_list, short_list, long_list

"""Few-shot demonstrations for reasoning-chain construction and triple selection.

Original demonstration data with the same SCHEMA as the reference's
`prompts/kg_selection/*_demonstrations.py`:

- ``*_REASONING_CHAIN_EXAMPLARS``: ``{"question", "chains", "answer"}`` where
  ``chains`` is a comma-separated sequence of ``<h; r; t>`` triples — consumed
  by the chain constructor prompt (`knowledge_graph/models.py:1544-1561`).
- ``*_TRIPLE_SELECTION_EXAMPLARS``: per-hop multiple-choice records
  ``{"question", "triples", "candidate_triples", "answer", "cot_answer"}`` —
  consumed by the optional LLM TripleSelector.
"""

HOTPOTQA_REASONING_CHAIN_EXAMPLARS = [
    {
        "question": "In which country is the bridge named after the inventor of the phonograph?",
        "chains": "<Edison Bridge; named after; Thomas Edison>, "
                  "<Thomas Edison; invented; phonograph>, "
                  "<Edison Bridge; located in; New Jersey>, "
                  "<New Jersey; country; United States>",
        "answer": "United States",
    },
    {
        "question": "What award did the debut film of the director of Monsoon Wedding win?",
        "chains": "<Monsoon Wedding; directed by; Mira Nair>, "
                  "<Salaam Bombay!; debut feature film of; Mira Nair>, "
                  "<Salaam Bombay!; won; Camera d'Or>",
        "answer": "Camera d'Or",
    },
    {
        "question": "Which rocket was developed under the leadership of a scientist brought to "
                    "America by Operation Paperclip?",
        "chains": "<Operation Paperclip; brought to America; German scientists>, "
                  "<Wernher von Braun; participant of; Operation Paperclip>, "
                  "<Wernher von Braun; led the development of; Saturn V rocket>",
        "answer": "Saturn V",
    },
    {
        "question": "Who managed the band that recorded The Velvet Underground & Nico?",
        "chains": "<The Velvet Underground & Nico; recorded by; The Velvet Underground>, "
                  "<The Velvet Underground; managed by; Andy Warhol>",
        "answer": "Andy Warhol",
    },
    {
        "question": "Is the deepest lake in the world located in Russia or Canada?",
        "chains": "<Lake Baikal; is; deepest lake in the world>, "
                  "<Lake Baikal; located in; southern Siberia, Russia>",
        "answer": "Russia",
    },
]

WIKIMULTIHOPQA_REASONING_CHAIN_EXAMPLARS = [
    {
        "question": "Who was the father of the Queen of England married to Henry VI?",
        "chains": "<Margaret of Anjou; spouse; Henry VI>, "
                  "<Margaret of Anjou; father; Rene, King of Naples>",
        "answer": "Rene, King of Naples",
    },
    {
        "question": "Where did the director of A Trip to the Moon die?",
        "chains": "<A Trip to the Moon; directed by; Georges Melies>, "
                  "<Georges Melies; place of death; Paris>",
        "answer": "Paris",
    },
    {
        "question": "Who directed the film whose score was composed by the composer born in Frankfurt in 1957?",
        "chains": "<Hans Zimmer; born in; Frankfurt>, "
                  "<Hans Zimmer; composed the score for; Inception>, "
                  "<Inception; directed by; Christopher Nolan>",
        "answer": "Christopher Nolan",
    },
    {
        "question": "Which dynasty was founded by the builder of Tughlaqabad Fort?",
        "chains": "<Tughlaqabad Fort; built by; Ghiyas-ud-din Tughlaq>, "
                  "<Ghiyas-ud-din Tughlaq; founder of; Tughlaq dynasty>",
        "answer": "Tughlaq dynasty",
    },
    {
        "question": "Who taught piano to the wife of Robert Schumann?",
        "chains": "<Clara Schumann; spouse; Robert Schumann>, "
                  "<Friedrich Wieck; was piano teacher of; Clara Schumann>",
        "answer": "Friedrich Wieck",
    },
]

MUSIQUE_REASONING_CHAIN_EXAMPLARS = [
    {
        "question": "In which country is the largest seaport in Europe?",
        "chains": "<Port of Rotterdam; is; largest seaport in Europe>, "
                  "<Port of Rotterdam; located in; Rotterdam>, "
                  "<Rotterdam; located in province; South Holland>, "
                  "<South Holland; country; Netherlands>",
        "answer": "Netherlands",
    },
    {
        "question": "In which city did the New Zealand soprano perform at the 1981 royal wedding?",
        "chains": "<Kiri Te Kanawa; is; New Zealand soprano>, "
                  "<Kiri Te Kanawa; performed at; wedding of Prince Charles and Lady Diana Spencer>, "
                  "<wedding of Prince Charles and Lady Diana Spencer; held at; St Paul's Cathedral>, "
                  "<St Paul's Cathedral; located in; London>",
        "answer": "London",
    },
    {
        "question": "In which state is the national park containing mainland Australia's highest mountain?",
        "chains": "<Mount Kosciuszko; is; highest mountain in mainland Australia>, "
                  "<Mount Kosciuszko; within; Kosciuszko National Park>, "
                  "<Kosciuszko National Park; located in; New South Wales>",
        "answer": "New South Wales",
    },
    {
        "question": "Who produced the third album of the band from Abingdon?",
        "chains": "<Radiohead; from; Abingdon, Oxfordshire>, "
                  "<OK Computer; third album of; Radiohead>, "
                  "<OK Computer; produced with; Nigel Godrich>",
        "answer": "Nigel Godrich",
    },
]

HOTPOTQA_TRIPLE_SELECTION_EXAMPLARS = [
    {
        "question": "What award did the debut film of the director of Monsoon Wedding win?",
        "triples": [],
        "candidate_triples": [
            "A. <Monsoon Wedding; directed by; Mira Nair>",
            "B. <Salaam Bombay!; won; Camera d'Or>",
            "C. <Mira Nair; born in; Rourkela, Odisha>",
            "D. <Lake Baikal; is a; rift lake>",
            "E. <The Velvet Underground; formed in; 1964>",
        ],
        "answer": "A",
        "cot_answer": "The question asks about the debut film of Monsoon Wedding's director, so "
                      "first identify the director. The answer is: A.",
    },
    {
        "question": "What award did the debut film of the director of Monsoon Wedding win?",
        "triples": ["<Monsoon Wedding; directed by; Mira Nair>"],
        "candidate_triples": [
            "A. <Mira Nair; born in; Rourkela, Odisha>",
            "B. <Salaam Bombay!; debut feature film of; Mira Nair>",
            "C. <Edison Bridge; named after; Thomas Edison>",
            "D. <Camera d'Or; awarded at; 1988 Cannes Film Festival>",
            "E. <Operation Paperclip; occurred after; World War II>",
        ],
        "answer": "B",
        "cot_answer": "Knowing Mira Nair directed Monsoon Wedding, the next step is her debut "
                      "feature film. The answer is: B.",
    },
    {
        "question": "What award did the debut film of the director of Monsoon Wedding win?",
        "triples": [
            "<Monsoon Wedding; directed by; Mira Nair>",
            "<Salaam Bombay!; debut feature film of; Mira Nair>",
        ],
        "candidate_triples": [
            "A. <Camera d'Or; awarded at; 1988 Cannes Film Festival>",
            "B. <Salaam Bombay!; won; Camera d'Or>",
            "C. <Mira Nair; is; Indian-American filmmaker>",
            "D. <The Velvet Underground; managed by; Andy Warhol>",
            "E. <Lake Baikal; depth; 1,642 metres>",
        ],
        "answer": "B",
        "cot_answer": "The chain identified Salaam Bombay! as the debut film; now the award it "
                      "won completes the path. The answer is: B.",
    },
]

WIKIMULTIHOPQA_TRIPLE_SELECTION_EXAMPLARS = [
    {
        "question": "Where did the director of A Trip to the Moon die?",
        "triples": [],
        "candidate_triples": [
            "A. <A Trip to the Moon; directed by; Georges Melies>",
            "B. <Georges Melies; year of death; 1938>",
            "C. <Hans Zimmer; born in; Frankfurt>",
            "D. <Margaret of Anjou; spouse; Henry VI>",
            "E. <Tughlaqabad Fort; built in; 1321>",
        ],
        "answer": "A",
        "cot_answer": "First identify who directed A Trip to the Moon. The answer is: A.",
    },
    {
        "question": "Where did the director of A Trip to the Moon die?",
        "triples": ["<A Trip to the Moon; directed by; Georges Melies>"],
        "candidate_triples": [
            "A. <Georges Melies; year of death; 1938>",
            "B. <Georges Melies; place of death; Paris>",
            "C. <A Trip to the Moon; is a; 1902 French science fiction film>",
            "D. <Clara Schumann; father; Friedrich Wieck>",
            "E. <Inception; directed by; Christopher Nolan>",
        ],
        "answer": "B",
        "cot_answer": "The chain identifies Georges Melies as the director; the question asks "
                      "where he died. The answer is: B.",
    },
]

MUSIQUE_TRIPLE_SELECTION_EXAMPLARS = [
    {
        "question": "In which country is the largest seaport in Europe?",
        "triples": ["<Port of Rotterdam; is; largest seaport in Europe>",
                    "<Port of Rotterdam; located in; Rotterdam>"],
        "candidate_triples": [
            "A. <Rotterdam; located in province; South Holland>",
            "B. <Radiohead; formed in; 1985>",
            "C. <Mount Kosciuszko; part of range; Snowy Mountains>",
            "D. <Kiri Te Kanawa; is; New Zealand soprano>",
            "E. <OK Computer; third album of; Radiohead>",
        ],
        "answer": "A",
        "cot_answer": "The port is in Rotterdam; to reach the country, the province comes next. "
                      "The answer is: A.",
    },
]


HOTPOTQA_REASONING_CHAIN_EXAMPLARS += [
    {
        "question": "Who engineered the suspension bridge that connects San Francisco to Marin County?",
        "chains": "<Golden Gate Bridge; connects; San Francisco and Marin County>, "
                  "<Golden Gate Bridge; chief engineer; Joseph Strauss>",
        "answer": "Joseph Strauss",
    },
    {
        "question": "Who starred in the 1998 film adaptation of the Pulitzer-winning novel by the 1993 Nobel laureate in Literature?",
        "chains": "<Toni Morrison; won; Nobel Prize in Literature>, "
                  "<Toni Morrison; Nobel Prize year; 1993>, "
                  "<Beloved; written by; Toni Morrison>, "
                  "<Beloved; adapted into film in; 1998>, "
                  "<Beloved (1998 film); starring; Oprah Winfrey>",
        "answer": "Oprah Winfrey",
    },
    {
        "question": "Near which city is the organization where the World Wide Web was invented?",
        "chains": "<World Wide Web; invented at; CERN>, <CERN; located near; Geneva>",
        "answer": "Geneva",
    },
]

WIKIMULTIHOPQA_REASONING_CHAIN_EXAMPLARS += [
    {
        "question": "Who was the father of the mathematician who worked with Charles Babbage?",
        "chains": "<Ada Lovelace; worked with; Charles Babbage>, "
                  "<Ada Lovelace; father; Lord Byron>",
        "answer": "Lord Byron",
    },
    {
        "question": "Which studio produced the film that won the Academy Award for Best Animated Feature in 2003?",
        "chains": "<Spirited Away; won; Academy Award for Best Animated Feature>, "
                  "<Spirited Away; Academy Award year; 2003>, "
                  "<Spirited Away; produced by; Studio Ghibli>",
        "answer": "Studio Ghibli",
    },
]

MUSIQUE_REASONING_CHAIN_EXAMPLARS += [
    {
        "question": "In which country is the citadel publicized by Hiram Bingham in 1911?",
        "chains": "<Machu Picchu; publicized by; Hiram Bingham>, "
                  "<Machu Picchu; located in; Cusco Region>, "
                  "<Cusco Region; country; Peru>",
        "answer": "Peru",
    },
    {
        "question": "Who was the first director-general of the broadcaster headquartered in the City of Westminster?",
        "chains": "<British Broadcasting Corporation; headquartered at; Broadcasting House>, "
                  "<Broadcasting House; located in; City of Westminster>, "
                  "<British Broadcasting Corporation; first director-general; John Reith>",
        "answer": "John Reith",
    },
]

HOTPOTQA_TRIPLE_SELECTION_EXAMPLARS += [
    {
        "question": "Near which city is the organization where the World Wide Web was invented?",
        "triples": ["<World Wide Web; invented at; CERN>"],
        "candidate_triples": [
            "A. <CERN; operates; Large Hadron Collider>",
            "B. <CERN; located near; Geneva>",
            "C. <World Wide Web; invented by; Tim Berners-Lee>",
            "D. <Golden Gate Bridge; opened in; 1937>",
            "E. <Toni Morrison; was; American novelist>",
        ],
        "answer": "B",
        "cot_answer": "The chain places the invention at CERN; the question asks for the "
                      "nearby city. The answer is: B.",
    },
]


# ---------------------------------------------------------------------------
# Round-2 bank extension: the adaptive examplar RANKER
# (`kg/kg_generator.py` / `pipeline/kirag.py`) needs a real pool to rank over
# — the reference ships dozens of chain examplars and ~10 per-hop selection
# examplars per dataset (`prompts/kg_selection/hotpotqa_demonstrations.py:
# 1-120,1028-1048`). All records below are original text in the same schema.
# ---------------------------------------------------------------------------

HOTPOTQA_REASONING_CHAIN_EXAMPLARS += [
    {
        "question": "Who designed the tower that served as the entrance arch to the 1889 "
                    "World's Fair in Paris?",
        "chains": "<Eiffel Tower; served as; entrance arch to the 1889 World's Fair>, "
                  "<Eiffel Tower; located in; Paris>, "
                  "<Eiffel Tower; designed by; Gustave Eiffel>",
        "answer": "Gustave Eiffel",
    },
    {
        "question": "In which city is the museum housing the raft on which Thor Heyerdahl "
                    "crossed the Pacific in 1947?",
        "chains": "<Kon-Tiki; raft of; Thor Heyerdahl>, "
                  "<Kon-Tiki; crossed the Pacific in; 1947>, "
                  "<Kon-Tiki; displayed at; Kon-Tiki Museum>, "
                  "<Kon-Tiki Museum; located in; Oslo>",
        "answer": "Oslo",
    },
    {
        "question": "Which element did the first person to win two Nobel Prizes discover "
                    "together with her husband?",
        "chains": "<Marie Curie; was; first person to win two Nobel Prizes>, "
                  "<Marie Curie; spouse; Pierre Curie>, "
                  "<Marie Curie and Pierre Curie; discovered; polonium>",
        "answer": "polonium",
    },
    {
        "question": "In which Ohio town was the first person to walk on the Moon born?",
        "chains": "<Apollo 11; first Moon landing mission; 1969>, "
                  "<Neil Armstrong; first person to walk on; the Moon>, "
                  "<Neil Armstrong; born in; Wapakoneta, Ohio>",
        "answer": "Wapakoneta",
    },
    {
        "question": "In which city did the creator of Sherlock Holmes study medicine?",
        "chains": "<Sherlock Holmes; created by; Arthur Conan Doyle>, "
                  "<Arthur Conan Doyle; studied medicine in; Edinburgh>",
        "answer": "Edinburgh",
    },
    {
        "question": "Which structure stood longer, the Berlin Wall or the original "
                    "Crystal Palace in Hyde Park?",
        "chains": "<Berlin Wall; erected in; 1961>, <Berlin Wall; fell in; 1989>, "
                  "<Crystal Palace; built in Hyde Park in; 1851>, "
                  "<Crystal Palace; relocated from Hyde Park in; 1854>",
        "answer": "the Berlin Wall",
    },
    {
        "question": "Which Sherpa accompanied the New Zealand mountaineer on the first "
                    "ascent of Everest?",
        "chains": "<Edmund Hillary; was; New Zealand mountaineer>, "
                  "<Edmund Hillary; first ascent of Everest in; 1953>, "
                  "<Edmund Hillary; climbed with; Tenzing Norgay>",
        "answer": "Tenzing Norgay",
    },
    {
        "question": "For whom was the mausoleum in Agra commissioned by Shah Jahan built?",
        "chains": "<Taj Mahal; located in; Agra>, "
                  "<Taj Mahal; commissioned by; Shah Jahan>, "
                  "<Taj Mahal; built in memory of; Mumtaz Mahal>",
        "answer": "Mumtaz Mahal",
    },
    {
        "question": "What prize did the inventor of long-distance radio transmission share "
                    "in 1909?",
        "chains": "<Guglielmo Marconi; pioneered; long-distance radio transmission>, "
                  "<Guglielmo Marconi; shared in 1909; Nobel Prize in Physics>",
        "answer": "the Nobel Prize in Physics",
    },
    {
        "question": "Was the Eiffel Tower completed before or after Tower Bridge?",
        "chains": "<Eiffel Tower; completed in; 1889>, "
                  "<Tower Bridge; completed in; 1894>",
        "answer": "before",
    },
    {
        "question": "Who was married to the author of Frankenstein?",
        "chains": "<Frankenstein; written by; Mary Shelley>, "
                  "<Mary Shelley; spouse; Percy Bysshe Shelley>",
        "answer": "Percy Bysshe Shelley",
    },
    {
        "question": "Which novel by the author of Typee opens aboard a whaling ship "
                    "bound from Nantucket?",
        "chains": "<Typee; written by; Herman Melville>, "
                  "<Herman Melville; wrote; Moby-Dick>, "
                  "<Moby-Dick; opens aboard a whaler from; Nantucket>",
        "answer": "Moby-Dick",
    },
]

WIKIMULTIHOPQA_REASONING_CHAIN_EXAMPLARS += [
    {
        "question": "Where was the director of Seven Samurai born?",
        "chains": "<Seven Samurai; directed by; Akira Kurosawa>, "
                  "<Akira Kurosawa; place of birth; Tokyo>",
        "answer": "Tokyo",
    },
    {
        "question": "When did the composer of The Magic Flute die?",
        "chains": "<The Magic Flute; composed by; Wolfgang Amadeus Mozart>, "
                  "<Wolfgang Amadeus Mozart; year of death; 1791>",
        "answer": "1791",
    },
    {
        "question": "Where did the author of War and Peace die?",
        "chains": "<War and Peace; written by; Leo Tolstoy>, "
                  "<Leo Tolstoy; place of death; Astapovo>",
        "answer": "Astapovo",
    },
    {
        "question": "Which film was released first, Metropolis or Modern Times?",
        "chains": "<Metropolis; released in; 1927>, "
                  "<Modern Times; released in; 1936>",
        "answer": "Metropolis",
    },
    {
        "question": "Are Salvador Dali and Pablo Picasso of the same nationality?",
        "chains": "<Salvador Dali; nationality; Spanish>, "
                  "<Pablo Picasso; nationality; Spanish>",
        "answer": "yes",
    },
    {
        "question": "Who was the grandfather of Queen Victoria?",
        "chains": "<Queen Victoria; father; Prince Edward, Duke of Kent>, "
                  "<Prince Edward, Duke of Kent; father; George III>",
        "answer": "George III",
    },
    {
        "question": "Where did the founder of the Ford Motor Company die?",
        "chains": "<Ford Motor Company; founded by; Henry Ford>, "
                  "<Henry Ford; place of death; Dearborn, Michigan>",
        "answer": "Dearborn",
    },
    {
        "question": "When was the spouse of Frida Kahlo born?",
        "chains": "<Frida Kahlo; spouse; Diego Rivera>, "
                  "<Diego Rivera; year of birth; 1886>",
        "answer": "1886",
    },
    {
        "question": "At which university did the author of The Hobbit teach?",
        "chains": "<The Hobbit; written by; J. R. R. Tolkien>, "
                  "<J. R. R. Tolkien; taught at; University of Oxford>",
        "answer": "University of Oxford",
    },
    {
        "question": "Where was the performer of the song Imagine born?",
        "chains": "<Imagine; performed by; John Lennon>, "
                  "<John Lennon; place of birth; Liverpool>",
        "answer": "Liverpool",
    },
    {
        "question": "Who lived longer, Joseph Haydn or Franz Schubert?",
        "chains": "<Joseph Haydn; lifespan; 1732 to 1809>, "
                  "<Franz Schubert; lifespan; 1797 to 1828>",
        "answer": "Joseph Haydn",
    },
    {
        "question": "Who is the mother of the painter of Guernica?",
        "chains": "<Guernica; painted by; Pablo Picasso>, "
                  "<Pablo Picasso; mother; Maria Picasso Lopez>",
        "answer": "Maria Picasso Lopez",
    },
    {
        "question": "Did the director of Metropolis and the director of Modern Times "
                    "share a country of birth?",
        "chains": "<Metropolis; directed by; Fritz Lang>, "
                  "<Fritz Lang; country of birth; Austria>, "
                  "<Modern Times; directed by; Charlie Chaplin>, "
                  "<Charlie Chaplin; country of birth; England>",
        "answer": "no",
    },
]

MUSIQUE_REASONING_CHAIN_EXAMPLARS += [
    {
        "question": "Who founded the company that manufactures the 747 airliner?",
        "chains": "<747; manufactured by; Boeing>, "
                  "<Boeing; founded by; William Boeing>",
        "answer": "William Boeing",
    },
    {
        "question": "What is the capital of the country on whose border with Italy the "
                    "Matterhorn stands?",
        "chains": "<Matterhorn; stands on border of; Switzerland and Italy>, "
                  "<Switzerland; capital; Bern>",
        "answer": "Bern",
    },
    {
        "question": "Into which sea does the river that flows through Cairo empty?",
        "chains": "<Cairo; lies on; Nile>, "
                  "<Nile; empties into; Mediterranean Sea>",
        "answer": "Mediterranean Sea",
    },
    {
        "question": "What currency is used in the country where the Colosseum stands?",
        "chains": "<Colosseum; located in; Rome>, <Rome; country; Italy>, "
                  "<Italy; currency; euro>",
        "answer": "euro",
    },
    {
        "question": "Who wrote the novel on which the film Blade Runner is based?",
        "chains": "<Blade Runner; based on; Do Androids Dream of Electric Sheep?>, "
                  "<Do Androids Dream of Electric Sheep?; written by; Philip K. Dick>",
        "answer": "Philip K. Dick",
    },
    {
        "question": "In which mountain range is the highest peak of the country whose "
                    "capital is Kathmandu?",
        "chains": "<Kathmandu; capital of; Nepal>, "
                  "<Mount Everest; highest peak of; Nepal>, "
                  "<Mount Everest; part of; Himalayas>",
        "answer": "Himalayas",
    },
    {
        "question": "What language is official in the country whose capital hosts the "
                    "Prado Museum?",
        "chains": "<Prado Museum; located in; Madrid>, "
                  "<Madrid; capital of; Spain>, "
                  "<Spain; official language; Spanish>",
        "answer": "Spanish",
    },
    {
        "question": "Who directed the film whose title character is a computer named HAL 9000's "
                    "antagonist aboard Discovery One?",
        "chains": "<HAL 9000; appears in; 2001: A Space Odyssey>, "
                  "<2001: A Space Odyssey; directed by; Stanley Kubrick>",
        "answer": "Stanley Kubrick",
    },
    {
        "question": "On which continent is the desert that contains the Ahaggar Mountains?",
        "chains": "<Ahaggar Mountains; located in; Sahara>, "
                  "<Sahara; located on; Africa>",
        "answer": "Africa",
    },
    {
        "question": "Who succeeded the first president of the country whose largest city "
                    "is Istanbul?",
        "chains": "<Istanbul; largest city of; Turkey>, "
                  "<Mustafa Kemal Ataturk; first president of; Turkey>, "
                  "<Mustafa Kemal Ataturk; succeeded by; Ismet Inonu>",
        "answer": "Ismet Inonu",
    },
    {
        "question": "Which is older, the university where the author of The Hobbit taught "
                    "or the University of Cambridge?",
        "chains": "<The Hobbit; written by; J. R. R. Tolkien>, "
                  "<J. R. R. Tolkien; taught at; University of Oxford>, "
                  "<University of Oxford; teaching since; 1096>, "
                  "<University of Cambridge; founded in; 1209>",
        "answer": "University of Oxford",
    },
    {
        "question": "Which ocean borders the country containing the Atacama Desert?",
        "chains": "<Atacama Desert; located in; Chile>, "
                  "<Chile; borders; Pacific Ocean>",
        "answer": "Pacific Ocean",
    },
    {
        "question": "Who painted the ceiling of the chapel named after Pope Sixtus IV?",
        "chains": "<Sistine Chapel; named after; Pope Sixtus IV>, "
                  "<Sistine Chapel ceiling; painted by; Michelangelo>",
        "answer": "Michelangelo",
    },
    {
        "question": "What is the seat of the county in which the birthplace of Abraham "
                    "Lincoln is located?",
        "chains": "<Abraham Lincoln; born near; Hodgenville>, "
                  "<Hodgenville; located in; LaRue County>, "
                  "<LaRue County; county seat; Hodgenville>",
        "answer": "Hodgenville",
    },
]

HOTPOTQA_TRIPLE_SELECTION_EXAMPLARS += [
    {
        "question": "In which city is the museum housing the raft on which Thor Heyerdahl "
                    "crossed the Pacific in 1947?",
        "triples": [],
        "candidate_triples": [
            "A. <Kon-Tiki; raft of; Thor Heyerdahl>",
            "B. <Eiffel Tower; designed by; Gustave Eiffel>",
            "C. <Taj Mahal; located in; Agra>",
            "D. <Edmund Hillary; climbed with; Tenzing Norgay>",
            "E. <Marie Curie; spouse; Pierre Curie>",
        ],
        "answer": "A",
        "cot_answer": "The question concerns Thor Heyerdahl's raft, so first identify the "
                      "raft. The answer is: A.",
    },
    {
        "question": "In which city is the museum housing the raft on which Thor Heyerdahl "
                    "crossed the Pacific in 1947?",
        "triples": ["<Kon-Tiki; raft of; Thor Heyerdahl>"],
        "candidate_triples": [
            "A. <Kon-Tiki; crossed the Pacific in; 1947>",
            "B. <Kon-Tiki; displayed at; Kon-Tiki Museum>",
            "C. <Neil Armstrong; born in; Wapakoneta, Ohio>",
            "D. <Berlin Wall; erected in; 1961>",
            "E. <Frankenstein; written by; Mary Shelley>",
        ],
        "answer": "B",
        "cot_answer": "With the raft identified, the museum that displays it comes next. "
                      "The answer is: B.",
    },
    {
        "question": "In which city is the museum housing the raft on which Thor Heyerdahl "
                    "crossed the Pacific in 1947?",
        "triples": ["<Kon-Tiki; raft of; Thor Heyerdahl>",
                    "<Kon-Tiki; displayed at; Kon-Tiki Museum>"],
        "candidate_triples": [
            "A. <Kon-Tiki Museum; located in; Oslo>",
            "B. <Kon-Tiki; crossed the Pacific in; 1947>",
            "C. <Sherlock Holmes; created by; Arthur Conan Doyle>",
            "D. <Guglielmo Marconi; shared in 1909; Nobel Prize in Physics>",
            "E. <Tower Bridge; completed in; 1894>",
        ],
        "answer": "A",
        "cot_answer": "The museum is known; its city completes the chain. The answer is: A.",
    },
    {
        "question": "Which element did the first person to win two Nobel Prizes discover "
                    "together with her husband?",
        "triples": [],
        "candidate_triples": [
            "A. <Marie Curie; spouse; Pierre Curie>",
            "B. <Marie Curie; was; first person to win two Nobel Prizes>",
            "C. <Guglielmo Marconi; pioneered; long-distance radio transmission>",
            "D. <Apollo 11; first Moon landing mission; 1969>",
            "E. <Moby-Dick; opens aboard a whaler from; Nantucket>",
        ],
        "answer": "B",
        "cot_answer": "First resolve who won two Nobel Prizes first. The answer is: B.",
    },
    {
        "question": "Which element did the first person to win two Nobel Prizes discover "
                    "together with her husband?",
        "triples": ["<Marie Curie; was; first person to win two Nobel Prizes>"],
        "candidate_triples": [
            "A. <Marie Curie and Pierre Curie; discovered; polonium>",
            "B. <Marie Curie; spouse; Pierre Curie>",
            "C. <Eiffel Tower; completed in; 1889>",
            "D. <Taj Mahal; commissioned by; Shah Jahan>",
            "E. <Edmund Hillary; first ascent of Everest in; 1953>",
        ],
        "answer": "B",
        "cot_answer": "Knowing the laureate is Marie Curie, identify her husband before the "
                      "joint discovery. The answer is: B.",
    },
    {
        "question": "Which element did the first person to win two Nobel Prizes discover "
                    "together with her husband?",
        "triples": ["<Marie Curie; was; first person to win two Nobel Prizes>",
                    "<Marie Curie; spouse; Pierre Curie>"],
        "candidate_triples": [
            "A. <Kon-Tiki Museum; located in; Oslo>",
            "B. <Marie Curie and Pierre Curie; discovered; polonium>",
            "C. <Berlin Wall; fell in; 1989>",
            "D. <Mary Shelley; spouse; Percy Bysshe Shelley>",
            "E. <Neil Armstrong; first person to walk on; the Moon>",
        ],
        "answer": "B",
        "cot_answer": "The couple is established; their joint discovery answers the "
                      "question. The answer is: B.",
    },
    {
        "question": "Was the Eiffel Tower completed before or after Tower Bridge?",
        "triples": ["<Eiffel Tower; completed in; 1889>"],
        "candidate_triples": [
            "A. <Eiffel Tower; designed by; Gustave Eiffel>",
            "B. <Tower Bridge; completed in; 1894>",
            "C. <Taj Mahal; built in memory of; Mumtaz Mahal>",
            "D. <Arthur Conan Doyle; studied medicine in; Edinburgh>",
            "E. <Kon-Tiki; crossed the Pacific in; 1947>",
        ],
        "answer": "B",
        "cot_answer": "A comparison question needs the completion date of BOTH structures; "
                      "Tower Bridge's date is still missing. The answer is: B.",
    },
    {
        "question": "In which Ohio town was the first person to walk on the Moon born?",
        "triples": ["<Neil Armstrong; first person to walk on; the Moon>"],
        "candidate_triples": [
            "A. <Apollo 11; first Moon landing mission; 1969>",
            "B. <Neil Armstrong; born in; Wapakoneta, Ohio>",
            "C. <Edmund Hillary; was; New Zealand mountaineer>",
            "D. <Eiffel Tower; located in; Paris>",
            "E. <Herman Melville; wrote; Moby-Dick>",
        ],
        "answer": "B",
        "cot_answer": "Armstrong is identified; his birthplace answers the question "
                      "directly. The answer is: B.",
    },
]

WIKIMULTIHOPQA_TRIPLE_SELECTION_EXAMPLARS += [
    {
        "question": "Where was the director of Seven Samurai born?",
        "triples": [],
        "candidate_triples": [
            "A. <Akira Kurosawa; place of birth; Tokyo>",
            "B. <Seven Samurai; directed by; Akira Kurosawa>",
            "C. <Metropolis; released in; 1927>",
            "D. <Frida Kahlo; spouse; Diego Rivera>",
            "E. <War and Peace; written by; Leo Tolstoy>",
        ],
        "answer": "B",
        "cot_answer": "The director must be identified before his birthplace. "
                      "The answer is: B.",
    },
    {
        "question": "Where was the director of Seven Samurai born?",
        "triples": ["<Seven Samurai; directed by; Akira Kurosawa>"],
        "candidate_triples": [
            "A. <Akira Kurosawa; place of birth; Tokyo>",
            "B. <Seven Samurai; released in; 1954>",
            "C. <Leo Tolstoy; place of death; Astapovo>",
            "D. <Queen Victoria; father; Prince Edward, Duke of Kent>",
            "E. <Imagine; performed by; John Lennon>",
        ],
        "answer": "A",
        "cot_answer": "Kurosawa is the director; his birthplace completes the chain. "
                      "The answer is: A.",
    },
    {
        "question": "Who was the grandfather of Queen Victoria?",
        "triples": [],
        "candidate_triples": [
            "A. <Prince Edward, Duke of Kent; father; George III>",
            "B. <Queen Victoria; father; Prince Edward, Duke of Kent>",
            "C. <Henry Ford; place of death; Dearborn, Michigan>",
            "D. <The Hobbit; written by; J. R. R. Tolkien>",
            "E. <Salvador Dali; nationality; Spanish>",
        ],
        "answer": "B",
        "cot_answer": "A grandfather question resolves the father first. The answer is: B.",
    },
    {
        "question": "Who was the grandfather of Queen Victoria?",
        "triples": ["<Queen Victoria; father; Prince Edward, Duke of Kent>"],
        "candidate_triples": [
            "A. <Prince Edward, Duke of Kent; father; George III>",
            "B. <Queen Victoria; reigned from; 1837>",
            "C. <Wolfgang Amadeus Mozart; year of death; 1791>",
            "D. <Pablo Picasso; nationality; Spanish>",
            "E. <Ford Motor Company; founded by; Henry Ford>",
        ],
        "answer": "A",
        "cot_answer": "Her father's father is the grandfather asked for. The answer is: A.",
    },
    {
        "question": "Which film was released first, Metropolis or Modern Times?",
        "triples": [],
        "candidate_triples": [
            "A. <Metropolis; released in; 1927>",
            "B. <Metropolis; directed by; Fritz Lang>",
            "C. <Diego Rivera; year of birth; 1886>",
            "D. <John Lennon; place of birth; Liverpool>",
            "E. <Joseph Haydn; lifespan; 1732 to 1809>",
        ],
        "answer": "A",
        "cot_answer": "A release-date comparison needs each film's year; start with "
                      "Metropolis. The answer is: A.",
    },
    {
        "question": "Which film was released first, Metropolis or Modern Times?",
        "triples": ["<Metropolis; released in; 1927>"],
        "candidate_triples": [
            "A. <Modern Times; directed by; Charlie Chaplin>",
            "B. <Modern Times; released in; 1936>",
            "C. <Metropolis; directed by; Fritz Lang>",
            "D. <Franz Schubert; lifespan; 1797 to 1828>",
            "E. <Akira Kurosawa; place of birth; Tokyo>",
        ],
        "answer": "B",
        "cot_answer": "The other film's release year is the missing half of the "
                      "comparison. The answer is: B.",
    },
    {
        "question": "Are Salvador Dali and Pablo Picasso of the same nationality?",
        "triples": ["<Salvador Dali; nationality; Spanish>"],
        "candidate_triples": [
            "A. <Pablo Picasso; mother; Maria Picasso Lopez>",
            "B. <Pablo Picasso; nationality; Spanish>",
            "C. <Guernica; painted by; Pablo Picasso>",
            "D. <Salvador Dali; born in; Figueres>",
            "E. <Fritz Lang; country of birth; Austria>",
        ],
        "answer": "B",
        "cot_answer": "The comparison needs Picasso's nationality to match against "
                      "Dali's. The answer is: B.",
    },
    {
        "question": "When was the spouse of Frida Kahlo born?",
        "triples": ["<Frida Kahlo; spouse; Diego Rivera>"],
        "candidate_triples": [
            "A. <Diego Rivera; year of birth; 1886>",
            "B. <Frida Kahlo; born in; Coyoacan>",
            "C. <Leo Tolstoy; place of death; Astapovo>",
            "D. <Charlie Chaplin; country of birth; England>",
            "E. <Seven Samurai; directed by; Akira Kurosawa>",
        ],
        "answer": "A",
        "cot_answer": "Rivera is the spouse; his birth year is the target. The answer is: A.",
    },
    {
        "question": "At which university did the author of The Hobbit teach?",
        "triples": [],
        "candidate_triples": [
            "A. <J. R. R. Tolkien; taught at; University of Oxford>",
            "B. <The Hobbit; written by; J. R. R. Tolkien>",
            "C. <Imagine; performed by; John Lennon>",
            "D. <The Magic Flute; composed by; Wolfgang Amadeus Mozart>",
            "E. <Henry Ford; place of death; Dearborn, Michigan>",
        ],
        "answer": "B",
        "cot_answer": "Identify the author before where he taught. The answer is: B.",
    },
]

MUSIQUE_TRIPLE_SELECTION_EXAMPLARS += [
    {
        "question": "What currency is used in the country where the Colosseum stands?",
        "triples": [],
        "candidate_triples": [
            "A. <Colosseum; located in; Rome>",
            "B. <Italy; currency; euro>",
            "C. <Matterhorn; stands on border of; Switzerland and Italy>",
            "D. <Nile; empties into; Mediterranean Sea>",
            "E. <Boeing; founded by; William Boeing>",
        ],
        "answer": "A",
        "cot_answer": "Locate the Colosseum first, then climb to the country and its "
                      "currency. The answer is: A.",
    },
    {
        "question": "What currency is used in the country where the Colosseum stands?",
        "triples": ["<Colosseum; located in; Rome>"],
        "candidate_triples": [
            "A. <Rome; country; Italy>",
            "B. <Italy; currency; euro>",
            "C. <Cairo; lies on; Nile>",
            "D. <Madrid; capital of; Spain>",
            "E. <747; manufactured by; Boeing>",
        ],
        "answer": "A",
        "cot_answer": "Rome's country must come before the currency hop. The answer is: A.",
    },
    {
        "question": "What currency is used in the country where the Colosseum stands?",
        "triples": ["<Colosseum; located in; Rome>", "<Rome; country; Italy>"],
        "candidate_triples": [
            "A. <Italy; capital; Rome>",
            "B. <Italy; currency; euro>",
            "C. <Switzerland; capital; Bern>",
            "D. <Sahara; located on; Africa>",
            "E. <Mount Everest; part of; Himalayas>",
        ],
        "answer": "B",
        "cot_answer": "With Italy established, its currency answers the question. "
                      "The answer is: B.",
    },
    {
        "question": "Into which sea does the river that flows through Cairo empty?",
        "triples": [],
        "candidate_triples": [
            "A. <Nile; empties into; Mediterranean Sea>",
            "B. <Cairo; lies on; Nile>",
            "C. <Atacama Desert; located in; Chile>",
            "D. <Istanbul; largest city of; Turkey>",
            "E. <Blade Runner; based on; Do Androids Dream of Electric Sheep?>",
        ],
        "answer": "B",
        "cot_answer": "First identify Cairo's river, then where it ends. The answer is: B.",
    },
    {
        "question": "Into which sea does the river that flows through Cairo empty?",
        "triples": ["<Cairo; lies on; Nile>"],
        "candidate_triples": [
            "A. <Nile; empties into; Mediterranean Sea>",
            "B. <Nile; flows through; eleven countries>",
            "C. <Chile; borders; Pacific Ocean>",
            "D. <Kathmandu; capital of; Nepal>",
            "E. <Sistine Chapel; named after; Pope Sixtus IV>",
        ],
        "answer": "A",
        "cot_answer": "The Nile is the river; its mouth completes the chain. "
                      "The answer is: A.",
    },
    {
        "question": "Who succeeded the first president of the country whose largest city "
                    "is Istanbul?",
        "triples": [],
        "candidate_triples": [
            "A. <Mustafa Kemal Ataturk; first president of; Turkey>",
            "B. <Istanbul; largest city of; Turkey>",
            "C. <Rome; country; Italy>",
            "D. <Michelangelo; painted; Sistine Chapel ceiling>",
            "E. <Boeing; founded by; William Boeing>",
        ],
        "answer": "B",
        "cot_answer": "Resolve the country from its largest city before its first "
                      "president. The answer is: B.",
    },
    {
        "question": "Who succeeded the first president of the country whose largest city "
                    "is Istanbul?",
        "triples": ["<Istanbul; largest city of; Turkey>"],
        "candidate_triples": [
            "A. <Mustafa Kemal Ataturk; succeeded by; Ismet Inonu>",
            "B. <Mustafa Kemal Ataturk; first president of; Turkey>",
            "C. <Switzerland; capital; Bern>",
            "D. <Hodgenville; located in; LaRue County>",
            "E. <Prado Museum; located in; Madrid>",
        ],
        "answer": "B",
        "cot_answer": "Turkey is known; its first president is the next hop. "
                      "The answer is: B.",
    },
    {
        "question": "Who succeeded the first president of the country whose largest city "
                    "is Istanbul?",
        "triples": ["<Istanbul; largest city of; Turkey>",
                    "<Mustafa Kemal Ataturk; first president of; Turkey>"],
        "candidate_triples": [
            "A. <Mustafa Kemal Ataturk; succeeded by; Ismet Inonu>",
            "B. <Mustafa Kemal Ataturk; died in; 1938>",
            "C. <Abraham Lincoln; born near; Hodgenville>",
            "D. <2001: A Space Odyssey; directed by; Stanley Kubrick>",
            "E. <Spain; official language; Spanish>",
        ],
        "answer": "A",
        "cot_answer": "Ataturk's successor is exactly what the question asks. "
                      "The answer is: A.",
    },
    {
        "question": "Who painted the ceiling of the chapel named after Pope Sixtus IV?",
        "triples": ["<Sistine Chapel; named after; Pope Sixtus IV>"],
        "candidate_triples": [
            "A. <Sistine Chapel ceiling; painted by; Michelangelo>",
            "B. <Sistine Chapel; located in; Vatican City>",
            "C. <Do Androids Dream of Electric Sheep?; written by; Philip K. Dick>",
            "D. <Ahaggar Mountains; located in; Sahara>",
            "E. <Italy; currency; euro>",
        ],
        "answer": "A",
        "cot_answer": "The chapel is identified; the ceiling's painter is the final hop. "
                      "The answer is: A.",
    },
]

# -- round 4: bank depth to reference scale --------------------------------------
# The reference ships 20 multi-hop demonstration groups per dataset
# (`prompts/kg_selection/hotpotqa_demonstrations.py:1-1026` and siblings);
# the blocks below bring each bank to 20 unique-question groups of original
# content (2-3 per-hop records per group, mirroring the reference's
# group-of-hops structure).

HOTPOTQA_TRIPLE_SELECTION_EXAMPLARS += [
    {
        "question": "Which university awarded a doctorate to the physicist who proposed "
                    "the theory of general relativity?",
        "triples": [],
        "candidate_triples": [
            "A. <Albert Einstein; doctorate from; University of Zurich>",
            "B. <theory of general relativity; proposed by; Albert Einstein>",
            "C. <Wings; directed by; William A. Wellman>",
            "D. <Hungary; capital; Budapest>",
            "E. <Alfred Nobel; invented; dynamite>",
        ],
        "answer": "B",
        "cot_answer": "The physicist behind general relativity must be identified before "
                      "any university. The answer is: B.",
    },
    {
        "question": "Which university awarded a doctorate to the physicist who proposed "
                    "the theory of general relativity?",
        "triples": ["<theory of general relativity; proposed by; Albert Einstein>"],
        "candidate_triples": [
            "A. <Albert Einstein; born in; Ulm>",
            "B. <University of Zurich; located in; Switzerland>",
            "C. <Albert Einstein; doctorate from; University of Zurich>",
            "D. <The Beatles; formed in; Liverpool>",
            "E. <Enola Gay; is a; Boeing B-29 Superfortress>",
        ],
        "answer": "C",
        "cot_answer": "Einstein is established; his doctoral university answers the "
                      "question. The answer is: C.",
    },
    {
        "question": "In which city is the stadium that hosted the 1966 FIFA World Cup final?",
        "triples": [],
        "candidate_triples": [
            "A. <Wembley Stadium; located in; London>",
            "B. <1966 FIFA World Cup final; played at; Wembley Stadium>",
            "C. <Statue of Liberty; gifted by; France>",
            "D. <Albert Einstein; doctorate from; University of Zurich>",
            "E. <The Shard; tallest building in; London>",
        ],
        "answer": "B",
        "cot_answer": "The stadium must be found before its city. The answer is: B.",
    },
    {
        "question": "In which city is the stadium that hosted the 1966 FIFA World Cup final?",
        "triples": ["<1966 FIFA World Cup final; played at; Wembley Stadium>"],
        "candidate_triples": [
            "A. <Wembley Stadium; capacity; 90,000>",
            "B. <1966 FIFA World Cup; won by; England>",
            "C. <Wembley Stadium; located in; London>",
            "D. <Danube; flows through; Budapest>",
            "E. <Microsoft; co-founded by; Bill Gates>",
        ],
        "answer": "C",
        "cot_answer": "With Wembley identified, its city completes the chain. "
                      "The answer is: C.",
    },
    {
        "question": "Who wrote the play on which West Side Story is based?",
        "triples": [],
        "candidate_triples": [
            "A. <Romeo and Juliet; written by; William Shakespeare>",
            "B. <West Side Story; based on; Romeo and Juliet>",
            "C. <Leonard Bernstein; composed; West Side Story>",
            "D. <Wembley Stadium; located in; London>",
            "E. <France; capital; Paris>",
        ],
        "answer": "B",
        "cot_answer": "First find the play underlying West Side Story. The answer is: B.",
    },
    {
        "question": "Who wrote the play on which West Side Story is based?",
        "triples": ["<West Side Story; based on; Romeo and Juliet>"],
        "candidate_triples": [
            "A. <Romeo and Juliet; set in; Verona>",
            "B. <Romeo and Juliet; written by; William Shakespeare>",
            "C. <West Side Story; premiered in; 1957>",
            "D. <Abbey Road; recorded by; The Beatles>",
            "E. <University of Chicago; located in; Illinois>",
        ],
        "answer": "B",
        "cot_answer": "The play is Romeo and Juliet; its author is the final hop. "
                      "The answer is: B.",
    },
    {
        "question": "What is the capital of the country that gifted the Statue of Liberty "
                    "to the United States?",
        "triples": [],
        "candidate_triples": [
            "A. <France; capital; Paris>",
            "B. <Statue of Liberty; gifted by; France>",
            "C. <Statue of Liberty; stands on; Liberty Island>",
            "D. <printing press; invented by; Johannes Gutenberg>",
            "E. <Solomon R. Guggenheim Museum; located on; Fifth Avenue>",
        ],
        "answer": "B",
        "cot_answer": "Identify the gifting country before its capital. The answer is: B.",
    },
    {
        "question": "What is the capital of the country that gifted the Statue of Liberty "
                    "to the United States?",
        "triples": ["<Statue of Liberty; gifted by; France>"],
        "candidate_triples": [
            "A. <France; capital; Paris>",
            "B. <France; borders; Spain>",
            "C. <Statue of Liberty; designed by; Frederic Auguste Bartholdi>",
            "D. <Albert A. Michelson; professor at; University of Chicago>",
            "E. <2012 Summer Olympics; hosted by; London>",
        ],
        "answer": "A",
        "cot_answer": "France is the gifting country; its capital answers the question. "
                      "The answer is: A.",
    },
    {
        "question": "In which decade was the university that the co-founder of Microsoft "
                    "dropped out of established?",
        "triples": [],
        "candidate_triples": [
            "A. <Bill Gates; dropped out of; Harvard University>",
            "B. <Microsoft; co-founded by; Bill Gates>",
            "C. <Harvard University; established in; 1636>",
            "D. <Romeo and Juliet; written by; William Shakespeare>",
            "E. <Nile; empties into; Mediterranean Sea>",
        ],
        "answer": "B",
        "cot_answer": "The chain starts from Microsoft's co-founder. The answer is: B.",
    },
    {
        "question": "In which decade was the university that the co-founder of Microsoft "
                    "dropped out of established?",
        "triples": ["<Microsoft; co-founded by; Bill Gates>"],
        "candidate_triples": [
            "A. <Bill Gates; dropped out of; Harvard University>",
            "B. <Harvard University; established in; 1636>",
            "C. <Microsoft; headquartered in; Redmond>",
            "D. <fall of Constantinople; occurred in; 1453>",
            "E. <Budapest; lies on; Danube>",
        ],
        "answer": "A",
        "cot_answer": "Gates's university comes before its founding decade. "
                      "The answer is: A.",
    },
    {
        "question": "In which decade was the university that the co-founder of Microsoft "
                    "dropped out of established?",
        "triples": ["<Microsoft; co-founded by; Bill Gates>",
                    "<Bill Gates; dropped out of; Harvard University>"],
        "candidate_triples": [
            "A. <Harvard University; located in; Cambridge, Massachusetts>",
            "B. <Harvard University; established in; 1636>",
            "C. <Bill Gates; born in; Seattle>",
            "D. <Wembley Stadium; capacity; 90,000>",
            "E. <Statue of Liberty; designed by; Frederic Auguste Bartholdi>",
        ],
        "answer": "B",
        "cot_answer": "Harvard's founding year gives the decade the question asks for. "
                      "The answer is: B.",
    },
    {
        "question": "Who directed the film that won the first Academy Award for Best Picture?",
        "triples": [],
        "candidate_triples": [
            "A. <Wings; directed by; William A. Wellman>",
            "B. <Wings; won; first Academy Award for Best Picture>",
            "C. <Academy Awards; first held in; 1929>",
            "D. <Harvard University; established in; 1636>",
            "E. <Alfred Nobel; nationality; Swedish>",
        ],
        "answer": "B",
        "cot_answer": "The winning film must be identified before its director. "
                      "The answer is: B.",
    },
    {
        "question": "Who directed the film that won the first Academy Award for Best Picture?",
        "triples": ["<Wings; won; first Academy Award for Best Picture>"],
        "candidate_triples": [
            "A. <Wings; released in; 1927>",
            "B. <Academy Awards; first held in; 1929>",
            "C. <Wings; directed by; William A. Wellman>",
            "D. <University of Zurich; located in; Switzerland>",
            "E. <London; hosted; 2012 Summer Olympics>",
        ],
        "answer": "C",
        "cot_answer": "Wings is the film; its director is the final hop. The answer is: C.",
    },
    {
        "question": "On which river does the capital of Hungary lie?",
        "triples": [],
        "candidate_triples": [
            "A. <Budapest; lies on; Danube>",
            "B. <Hungary; capital; Budapest>",
            "C. <Danube; empties into; Black Sea>",
            "D. <Wings; released in; 1927>",
            "E. <Bill Gates; dropped out of; Harvard University>",
        ],
        "answer": "B",
        "cot_answer": "Hungary's capital is the bridge entity. The answer is: B.",
    },
    {
        "question": "On which river does the capital of Hungary lie?",
        "triples": ["<Hungary; capital; Budapest>"],
        "candidate_triples": [
            "A. <Budapest; lies on; Danube>",
            "B. <Danube; empties into; Black Sea>",
            "C. <Hungary; borders; Austria>",
            "D. <West Side Story; premiered in; 1957>",
            "E. <Enola Gay; dropped; first atomic bomb used in war>",
        ],
        "answer": "A",
        "cot_answer": "Budapest's river answers the question directly. The answer is: A.",
    },
    {
        "question": "Was the printing press invented before or after the fall of "
                    "Constantinople?",
        "triples": [],
        "candidate_triples": [
            "A. <fall of Constantinople; occurred in; 1453>",
            "B. <printing press; invented by Johannes Gutenberg around; 1440>",
            "C. <Johannes Gutenberg; born in; Mainz>",
            "D. <Budapest; lies on; Danube>",
            "E. <Romeo and Juliet; set in; Verona>",
        ],
        "answer": "B",
        "cot_answer": "A comparison question needs both dates; the press's invention date "
                      "is a sound first hop. The answer is: B.",
    },
    {
        "question": "Was the printing press invented before or after the fall of "
                    "Constantinople?",
        "triples": ["<printing press; invented by Johannes Gutenberg around; 1440>"],
        "candidate_triples": [
            "A. <Johannes Gutenberg; printed; 42-line Bible>",
            "B. <fall of Constantinople; occurred in; 1453>",
            "C. <Constantinople; renamed; Istanbul>",
            "D. <France; capital; Paris>",
            "E. <Microsoft; headquartered in; Redmond>",
        ],
        "answer": "B",
        "cot_answer": "The second date of the comparison is still missing. "
                      "The answer is: B.",
    },
    {
        "question": "Which company manufactured the bomber that dropped the first atomic "
                    "bomb used in war?",
        "triples": [],
        "candidate_triples": [
            "A. <Enola Gay; is a; Boeing B-29 Superfortress>",
            "B. <Enola Gay; dropped; first atomic bomb used in war>",
            "C. <B-29 Superfortress; manufactured by; Boeing>",
            "D. <1966 FIFA World Cup; won by; England>",
            "E. <Harvard University; located in; Cambridge, Massachusetts>",
        ],
        "answer": "B",
        "cot_answer": "Identify the aircraft first. The answer is: B.",
    },
    {
        "question": "Which company manufactured the bomber that dropped the first atomic "
                    "bomb used in war?",
        "triples": ["<Enola Gay; dropped; first atomic bomb used in war>"],
        "candidate_triples": [
            "A. <Enola Gay; is a; Boeing B-29 Superfortress>",
            "B. <Enola Gay; piloted by; Paul Tibbets>",
            "C. <Boeing; founded in; Seattle>",
            "D. <Sistine Chapel ceiling; painted by; Michelangelo>",
            "E. <Danube; empties into; Black Sea>",
        ],
        "answer": "A",
        "cot_answer": "The aircraft's type carries its manufacturer. The answer is: A.",
    },
    {
        "question": "In which US state is the university where the first American Nobel "
                    "laureate in physics taught?",
        "triples": [],
        "candidate_triples": [
            "A. <Albert A. Michelson; professor at; University of Chicago>",
            "B. <Albert A. Michelson; was; first American Nobel laureate in physics>",
            "C. <University of Chicago; located in; Illinois>",
            "D. <Enola Gay; piloted by; Paul Tibbets>",
            "E. <West Side Story; based on; Romeo and Juliet>",
        ],
        "answer": "B",
        "cot_answer": "The laureate must be named before his university. The answer is: B.",
    },
    {
        "question": "In which US state is the university where the first American Nobel "
                    "laureate in physics taught?",
        "triples": ["<Albert A. Michelson; was; first American Nobel laureate in physics>"],
        "candidate_triples": [
            "A. <Albert A. Michelson; measured; speed of light>",
            "B. <Albert A. Michelson; professor at; University of Chicago>",
            "C. <University of Chicago; founded in; 1890>",
            "D. <Boeing; founded in; Seattle>",
            "E. <Hungary; borders; Austria>",
        ],
        "answer": "B",
        "cot_answer": "Michelson's university is the next bridge. The answer is: B.",
    },
    {
        "question": "In which US state is the university where the first American Nobel "
                    "laureate in physics taught?",
        "triples": ["<Albert A. Michelson; was; first American Nobel laureate in physics>",
                    "<Albert A. Michelson; professor at; University of Chicago>"],
        "candidate_triples": [
            "A. <University of Chicago; founded in; 1890>",
            "B. <Illinois; capital; Springfield>",
            "C. <University of Chicago; located in; Illinois>",
            "D. <Johannes Gutenberg; born in; Mainz>",
            "E. <Leonard Bernstein; composed; West Side Story>",
        ],
        "answer": "C",
        "cot_answer": "The university's state completes the chain. The answer is: C.",
    },
    {
        "question": "Which architect designed the spiral museum on Fifth Avenue in Manhattan?",
        "triples": [],
        "candidate_triples": [
            "A. <Solomon R. Guggenheim Museum; located on; Fifth Avenue>",
            "B. <Solomon R. Guggenheim Museum; designed by; Frank Lloyd Wright>",
            "C. <Frank Lloyd Wright; designed; Fallingwater>",
            "D. <Albert A. Michelson; measured; speed of light>",
            "E. <1966 FIFA World Cup final; played at; Wembley Stadium>",
        ],
        "answer": "A",
        "cot_answer": "The museum itself must be identified from its location and form "
                      "first. The answer is: A.",
    },
    {
        "question": "Which architect designed the spiral museum on Fifth Avenue in Manhattan?",
        "triples": ["<Solomon R. Guggenheim Museum; located on; Fifth Avenue>"],
        "candidate_triples": [
            "A. <Solomon R. Guggenheim Museum; opened in; 1959>",
            "B. <Frank Lloyd Wright; designed; Fallingwater>",
            "C. <Solomon R. Guggenheim Museum; designed by; Frank Lloyd Wright>",
            "D. <Paris; capital of; France>",
            "E. <B-29 Superfortress; manufactured by; Boeing>",
        ],
        "answer": "C",
        "cot_answer": "With the museum fixed, its architect answers the question. "
                      "The answer is: C.",
    },
    {
        "question": "What nationality was the inventor of dynamite who endowed a set of "
                    "annual prizes?",
        "triples": [],
        "candidate_triples": [
            "A. <Alfred Nobel; nationality; Swedish>",
            "B. <Alfred Nobel; invented; dynamite>",
            "C. <Nobel Prizes; first awarded in; 1901>",
            "D. <Solomon R. Guggenheim Museum; opened in; 1959>",
            "E. <Romeo and Juliet; written by; William Shakespeare>",
        ],
        "answer": "B",
        "cot_answer": "The inventor must be established before his nationality. "
                      "The answer is: B.",
    },
    {
        "question": "What nationality was the inventor of dynamite who endowed a set of "
                    "annual prizes?",
        "triples": ["<Alfred Nobel; invented; dynamite>"],
        "candidate_triples": [
            "A. <Alfred Nobel; endowed; Nobel Prizes>",
            "B. <Alfred Nobel; nationality; Swedish>",
            "C. <Nobel Prizes; first awarded in; 1901>",
            "D. <Frank Lloyd Wright; designed; Fallingwater>",
            "E. <England; won; 1966 FIFA World Cup>",
        ],
        "answer": "B",
        "cot_answer": "Nobel's nationality is exactly what is asked. The answer is: B.",
    },
    {
        "question": "In which city did the band that recorded the album Abbey Road form?",
        "triples": [],
        "candidate_triples": [
            "A. <The Beatles; formed in; Liverpool>",
            "B. <Abbey Road; recorded by; The Beatles>",
            "C. <Abbey Road Studios; located in; London>",
            "D. <Alfred Nobel; endowed; Nobel Prizes>",
            "E. <University of Chicago; located in; Illinois>",
        ],
        "answer": "B",
        "cot_answer": "The band behind the album comes first. The answer is: B.",
    },
    {
        "question": "In which city did the band that recorded the album Abbey Road form?",
        "triples": ["<Abbey Road; recorded by; The Beatles>"],
        "candidate_triples": [
            "A. <The Beatles; formed in; Liverpool>",
            "B. <Abbey Road Studios; located in; London>",
            "C. <The Beatles; disbanded in; 1970>",
            "D. <printing press; invented by Johannes Gutenberg around; 1440>",
            "E. <Statue of Liberty; stands on; Liberty Island>",
        ],
        "answer": "A",
        "cot_answer": "The Beatles' formation city answers the question — not the "
                      "studio's city. The answer is: A.",
    },
    {
        "question": "What is the tallest building in the city that hosted the 2012 Summer "
                    "Olympics?",
        "triples": [],
        "candidate_triples": [
            "A. <The Shard; tallest building in; London>",
            "B. <2012 Summer Olympics; hosted by; London>",
            "C. <London; lies on; Thames>",
            "D. <The Beatles; disbanded in; 1970>",
            "E. <Albert Einstein; born in; Ulm>",
        ],
        "answer": "B",
        "cot_answer": "Resolve the host city before its tallest building. "
                      "The answer is: B.",
    },
    {
        "question": "What is the tallest building in the city that hosted the 2012 Summer "
                    "Olympics?",
        "triples": ["<2012 Summer Olympics; hosted by; London>"],
        "candidate_triples": [
            "A. <London; lies on; Thames>",
            "B. <The Shard; completed in; 2012>",
            "C. <The Shard; tallest building in; London>",
            "D. <Alfred Nobel; invented; dynamite>",
            "E. <Wings; won; first Academy Award for Best Picture>",
        ],
        "answer": "C",
        "cot_answer": "London's tallest building completes the chain. The answer is: C.",
    },
]

WIKIMULTIHOPQA_TRIPLE_SELECTION_EXAMPLARS += [
    {
        "question": "Where was the composer of The Four Seasons born?",
        "triples": [],
        "candidate_triples": [
            "A. <Antonio Vivaldi; place of birth; Venice>",
            "B. <The Four Seasons; composed by; Antonio Vivaldi>",
            "C. <Antonio Vivaldi; occupation; composer and violinist>",
            "D. <War and Peace; written by; Leo Tolstoy>",
            "E. <Mount Elbrus; elevation; 5,642 metres>",
        ],
        "answer": "B",
        "cot_answer": "The composer must be identified before his birthplace. "
                      "The answer is: B.",
    },
    {
        "question": "Where was the composer of The Four Seasons born?",
        "triples": ["<The Four Seasons; composed by; Antonio Vivaldi>"],
        "candidate_triples": [
            "A. <Antonio Vivaldi; place of birth; Venice>",
            "B. <Antonio Vivaldi; died in; Vienna>",
            "C. <The Four Seasons; published in; 1725>",
            "D. <Psycho; directed by; Alfred Hitchcock>",
            "E. <Jane Austen; country of citizenship; England>",
        ],
        "answer": "A",
        "cot_answer": "Vivaldi's birthplace answers the question — not where he died. "
                      "The answer is: A.",
    },
    {
        "question": "Which film was released first, Citizen Kane or Casablanca?",
        "triples": [],
        "candidate_triples": [
            "A. <Casablanca; released in; 1942>",
            "B. <Citizen Kane; released in; 1941>",
            "C. <Citizen Kane; directed by; Orson Welles>",
            "D. <Antonio Vivaldi; died in; Vienna>",
            "E. <penicillin; discovered by; Alexander Fleming>",
        ],
        "answer": "B",
        "cot_answer": "A release-order comparison needs both dates; either is a valid "
                      "first hop. The answer is: B.",
    },
    {
        "question": "Which film was released first, Citizen Kane or Casablanca?",
        "triples": ["<Citizen Kane; released in; 1941>"],
        "candidate_triples": [
            "A. <Casablanca; released in; 1942>",
            "B. <Casablanca; starring; Humphrey Bogart>",
            "C. <Citizen Kane; directed by; Orson Welles>",
            "D. <Leo Tolstoy; place of death; Astapovo>",
            "E. <Moonlight Sonata; composed by; Ludwig van Beethoven>",
        ],
        "answer": "A",
        "cot_answer": "Casablanca's date is the missing half of the comparison. "
                      "The answer is: A.",
    },
    {
        "question": "When did the founder of the Ford Motor Company die?",
        "triples": [],
        "candidate_triples": [
            "A. <Henry Ford; date of death; 7 April 1947>",
            "B. <Ford Motor Company; founded by; Henry Ford>",
            "C. <Ford Motor Company; founded in; 1903>",
            "D. <Citizen Kane; released in; 1941>",
            "E. <Vincent van Gogh; painted; The Starry Night>",
        ],
        "answer": "B",
        "cot_answer": "Identify the founder first. The answer is: B.",
    },
    {
        "question": "When did the founder of the Ford Motor Company die?",
        "triples": ["<Ford Motor Company; founded by; Henry Ford>"],
        "candidate_triples": [
            "A. <Henry Ford; born in; 1863>",
            "B. <Henry Ford; date of death; 7 April 1947>",
            "C. <Ford Motor Company; headquartered in; Dearborn>",
            "D. <The Four Seasons; published in; 1725>",
            "E. <Marie Antoinette; spouse; Louis XVI>",
        ],
        "answer": "B",
        "cot_answer": "Ford's death date is what the question asks. The answer is: B.",
    },
    {
        "question": "Are Jane Austen and Charles Dickens of the same nationality?",
        "triples": [],
        "candidate_triples": [
            "A. <Jane Austen; country of citizenship; England>",
            "B. <Charles Dickens; wrote; Great Expectations>",
            "C. <Jane Austen; wrote; Pride and Prejudice>",
            "D. <Henry Ford; born in; 1863>",
            "E. <Mont Blanc; elevation; 4,808 metres>",
        ],
        "answer": "A",
        "cot_answer": "A nationality comparison needs each author's citizenship; start "
                      "with Austen. The answer is: A.",
    },
    {
        "question": "Are Jane Austen and Charles Dickens of the same nationality?",
        "triples": ["<Jane Austen; country of citizenship; England>"],
        "candidate_triples": [
            "A. <Charles Dickens; country of citizenship; England>",
            "B. <Charles Dickens; wrote; Great Expectations>",
            "C. <Jane Austen; died in; Winchester>",
            "D. <Ford Motor Company; founded in; 1903>",
            "E. <Isaac Newton; father; Isaac Newton Sr.>",
        ],
        "answer": "A",
        "cot_answer": "Dickens's citizenship completes the comparison. The answer is: A.",
    },
    {
        "question": "Who was the father of the scientist who formulated the laws of motion?",
        "triples": [],
        "candidate_triples": [
            "A. <Isaac Newton; father; Isaac Newton Sr.>",
            "B. <laws of motion; formulated by; Isaac Newton>",
            "C. <Isaac Newton; born in; Woolsthorpe>",
            "D. <Charles Dickens; country of citizenship; England>",
            "E. <Alfred Hitchcock; place of death; Bel Air, Los Angeles>",
        ],
        "answer": "B",
        "cot_answer": "The scientist must be resolved before his father. The answer is: B.",
    },
    {
        "question": "Who was the father of the scientist who formulated the laws of motion?",
        "triples": ["<laws of motion; formulated by; Isaac Newton>"],
        "candidate_triples": [
            "A. <Isaac Newton; born in; Woolsthorpe>",
            "B. <Isaac Newton; father; Isaac Newton Sr.>",
            "C. <Isaac Newton; wrote; Principia Mathematica>",
            "D. <Casablanca; starring; Humphrey Bogart>",
            "E. <Elizabeth II; father; George VI>",
        ],
        "answer": "B",
        "cot_answer": "Newton's father is the asked relation. The answer is: B.",
    },
    {
        "question": "Where did the author of War and Peace die?",
        "triples": [],
        "candidate_triples": [
            "A. <Leo Tolstoy; place of death; Astapovo>",
            "B. <War and Peace; written by; Leo Tolstoy>",
            "C. <Leo Tolstoy; born at; Yasnaya Polyana>",
            "D. <Isaac Newton; wrote; Principia Mathematica>",
            "E. <The Starry Night; painted by; Vincent van Gogh>",
        ],
        "answer": "B",
        "cot_answer": "The author is the bridge entity. The answer is: B.",
    },
    {
        "question": "Where did the author of War and Peace die?",
        "triples": ["<War and Peace; written by; Leo Tolstoy>"],
        "candidate_triples": [
            "A. <Leo Tolstoy; born at; Yasnaya Polyana>",
            "B. <War and Peace; published in; 1869>",
            "C. <Leo Tolstoy; place of death; Astapovo>",
            "D. <Louis XVI; crowned in; 1775>",
            "E. <Antonio Vivaldi; place of birth; Venice>",
        ],
        "answer": "C",
        "cot_answer": "Tolstoy's place of death answers the question — not his "
                      "birthplace. The answer is: C.",
    },
    {
        "question": "When was the spouse of Marie Antoinette crowned?",
        "triples": [],
        "candidate_triples": [
            "A. <Louis XVI; crowned in; 1775>",
            "B. <Marie Antoinette; spouse; Louis XVI>",
            "C. <Marie Antoinette; born in; Vienna>",
            "D. <Leo Tolstoy; born at; Yasnaya Polyana>",
            "E. <Ludwig van Beethoven; died in; 1827>",
        ],
        "answer": "B",
        "cot_answer": "Find the spouse before the coronation. The answer is: B.",
    },
    {
        "question": "When was the spouse of Marie Antoinette crowned?",
        "triples": ["<Marie Antoinette; spouse; Louis XVI>"],
        "candidate_triples": [
            "A. <Louis XVI; crowned in; 1775>",
            "B. <Louis XVI; executed in; 1793>",
            "C. <Marie Antoinette; born in; Vienna>",
            "D. <Vincent van Gogh; place of birth; Zundert>",
            "E. <Henry Ford; date of death; 7 April 1947>",
        ],
        "answer": "A",
        "cot_answer": "Louis XVI's coronation date is the asked fact. The answer is: A.",
    },
    {
        "question": "Which mountain is higher, Mont Blanc or Mount Elbrus?",
        "triples": [],
        "candidate_triples": [
            "A. <Mont Blanc; elevation; 4,808 metres>",
            "B. <Mont Blanc; located in; Alps>",
            "C. <Louis XVI; executed in; 1793>",
            "D. <Mount Elbrus; located in; Caucasus>",
            "E. <penicillin; discovered by; Alexander Fleming>",
        ],
        "answer": "A",
        "cot_answer": "A height comparison needs both elevations; take Mont Blanc's "
                      "first. The answer is: A.",
    },
    {
        "question": "Which mountain is higher, Mont Blanc or Mount Elbrus?",
        "triples": ["<Mont Blanc; elevation; 4,808 metres>"],
        "candidate_triples": [
            "A. <Mount Elbrus; elevation; 5,642 metres>",
            "B. <Mount Elbrus; located in; Caucasus>",
            "C. <Mont Blanc; located in; Alps>",
            "D. <Jane Austen; died in; Winchester>",
            "E. <George VI; mother; Mary of Teck>",
        ],
        "answer": "A",
        "cot_answer": "Elbrus's elevation is the missing half of the comparison. "
                      "The answer is: A.",
    },
    {
        "question": "Where was the painter of The Starry Night born?",
        "triples": [],
        "candidate_triples": [
            "A. <Vincent van Gogh; place of birth; Zundert>",
            "B. <The Starry Night; painted by; Vincent van Gogh>",
            "C. <Vincent van Gogh; died in; Auvers-sur-Oise>",
            "D. <Mount Elbrus; elevation; 5,642 metres>",
            "E. <Ford Motor Company; headquartered in; Dearborn>",
        ],
        "answer": "B",
        "cot_answer": "The painter is the bridge entity. The answer is: B.",
    },
    {
        "question": "Where was the painter of The Starry Night born?",
        "triples": ["<The Starry Night; painted by; Vincent van Gogh>"],
        "candidate_triples": [
            "A. <Vincent van Gogh; died in; Auvers-sur-Oise>",
            "B. <The Starry Night; held by; Museum of Modern Art>",
            "C. <Vincent van Gogh; place of birth; Zundert>",
            "D. <laws of motion; formulated by; Isaac Newton>",
            "E. <Alexander Fleming; studied at; St Mary's Hospital Medical School>",
        ],
        "answer": "C",
        "cot_answer": "Van Gogh's birthplace answers the question — not where he died. "
                      "The answer is: C.",
    },
    {
        "question": "Who was the paternal grandmother of Elizabeth II?",
        "triples": [],
        "candidate_triples": [
            "A. <George VI; mother; Mary of Teck>",
            "B. <Elizabeth II; father; George VI>",
            "C. <Elizabeth II; mother; Queen Elizabeth The Queen Mother>",
            "D. <The Starry Night; held by; Museum of Modern Art>",
            "E. <Moonlight Sonata; composed by; Ludwig van Beethoven>",
        ],
        "answer": "B",
        "cot_answer": "The paternal line starts at her father. The answer is: B.",
    },
    {
        "question": "Who was the paternal grandmother of Elizabeth II?",
        "triples": ["<Elizabeth II; father; George VI>"],
        "candidate_triples": [
            "A. <George VI; mother; Mary of Teck>",
            "B. <George VI; spouse; Queen Elizabeth The Queen Mother>",
            "C. <Elizabeth II; born in; 1926>",
            "D. <Citizen Kane; directed by; Orson Welles>",
            "E. <Mont Blanc; located in; Alps>",
        ],
        "answer": "A",
        "cot_answer": "George VI's mother is the paternal grandmother. The answer is: A.",
    },
    {
        "question": "Did the composer of the Moonlight Sonata die before or after the "
                    "premiere of his Ninth Symphony?",
        "triples": [],
        "candidate_triples": [
            "A. <Ludwig van Beethoven; died in; 1827>",
            "B. <Moonlight Sonata; composed by; Ludwig van Beethoven>",
            "C. <Ninth Symphony; premiered in; 1824>",
            "D. <George VI; spouse; Queen Elizabeth The Queen Mother>",
            "E. <Henry Ford; born in; 1863>",
        ],
        "answer": "B",
        "cot_answer": "The composer must be resolved before any dates. The answer is: B.",
    },
    {
        "question": "Did the composer of the Moonlight Sonata die before or after the "
                    "premiere of his Ninth Symphony?",
        "triples": ["<Moonlight Sonata; composed by; Ludwig van Beethoven>"],
        "candidate_triples": [
            "A. <Ludwig van Beethoven; died in; 1827>",
            "B. <Ludwig van Beethoven; born in; Bonn>",
            "C. <Moonlight Sonata; published in; 1802>",
            "D. <War and Peace; published in; 1869>",
            "E. <Mary of Teck; spouse; George V>",
        ],
        "answer": "A",
        "cot_answer": "With Beethoven fixed, the comparison needs his death year (and "
                      "then the premiere year). The answer is: A.",
    },
    {
        "question": "Did the composer of the Moonlight Sonata die before or after the "
                    "premiere of his Ninth Symphony?",
        "triples": ["<Moonlight Sonata; composed by; Ludwig van Beethoven>",
                    "<Ludwig van Beethoven; died in; 1827>"],
        "candidate_triples": [
            "A. <Ninth Symphony; premiered in; 1824>",
            "B. <Ludwig van Beethoven; born in; Bonn>",
            "C. <Moonlight Sonata; published in; 1802>",
            "D. <Elizabeth II; born in; 1926>",
            "E. <Casablanca; released in; 1942>",
        ],
        "answer": "A",
        "cot_answer": "The premiere year is the last missing fact of the comparison. "
                      "The answer is: A.",
    },
    {
        "question": "At which medical school did the discoverer of penicillin study?",
        "triples": [],
        "candidate_triples": [
            "A. <Alexander Fleming; studied at; St Mary's Hospital Medical School>",
            "B. <penicillin; discovered by; Alexander Fleming>",
            "C. <Alexander Fleming; born in; Lochfield>",
            "D. <Ninth Symphony; premiered in; 1824>",
            "E. <Leo Tolstoy; place of death; Astapovo>",
        ],
        "answer": "B",
        "cot_answer": "The discoverer is the bridge entity. The answer is: B.",
    },
    {
        "question": "At which medical school did the discoverer of penicillin study?",
        "triples": ["<penicillin; discovered by; Alexander Fleming>"],
        "candidate_triples": [
            "A. <Alexander Fleming; born in; Lochfield>",
            "B. <Alexander Fleming; studied at; St Mary's Hospital Medical School>",
            "C. <penicillin; mass-produced from; 1944>",
            "D. <The Four Seasons; composed by; Antonio Vivaldi>",
            "E. <Mount Elbrus; located in; Caucasus>",
        ],
        "answer": "B",
        "cot_answer": "Fleming's medical school answers the question. The answer is: B.",
    },
    {
        "question": "Where did the director of Psycho die?",
        "triples": [],
        "candidate_triples": [
            "A. <Alfred Hitchcock; place of death; Bel Air, Los Angeles>",
            "B. <Psycho; directed by; Alfred Hitchcock>",
            "C. <Alfred Hitchcock; born in; Leytonstone, London>",
            "D. <penicillin; mass-produced from; 1944>",
            "E. <Marie Antoinette; born in; Vienna>",
        ],
        "answer": "B",
        "cot_answer": "Identify Psycho's director first. The answer is: B.",
    },
    {
        "question": "Where did the director of Psycho die?",
        "triples": ["<Psycho; directed by; Alfred Hitchcock>"],
        "candidate_triples": [
            "A. <Alfred Hitchcock; born in; Leytonstone, London>",
            "B. <Psycho; released in; 1960>",
            "C. <Alfred Hitchcock; place of death; Bel Air, Los Angeles>",
            "D. <Isaac Newton; born in; Woolsthorpe>",
            "E. <Ludwig van Beethoven; born in; Bonn>",
        ],
        "answer": "C",
        "cot_answer": "Hitchcock's place of death answers the question — not his "
                      "birthplace. The answer is: C.",
    },
]

MUSIQUE_TRIPLE_SELECTION_EXAMPLARS += [
    {
        "question": "What is the official language of the country where Machu Picchu stands?",
        "triples": [],
        "candidate_triples": [
            "A. <Peru; official language; Spanish>",
            "B. <Machu Picchu; located in; Peru>",
            "C. <Machu Picchu; built by; Inca Empire>",
            "D. <Lisbon; lies on; Tagus>",
            "E. <Palace of Versailles; built under; Louis XIV>",
        ],
        "answer": "B",
        "cot_answer": "Locate Machu Picchu's country first. The answer is: B.",
    },
    {
        "question": "What is the official language of the country where Machu Picchu stands?",
        "triples": ["<Machu Picchu; located in; Peru>"],
        "candidate_triples": [
            "A. <Peru; capital; Lima>",
            "B. <Peru; official language; Spanish>",
            "C. <Machu Picchu; built by; Inca Empire>",
            "D. <Vienna; lies on; Danube>",
            "E. <Mount Vesuvius; located in; Campania>",
        ],
        "answer": "B",
        "cot_answer": "Peru's official language completes the chain. The answer is: B.",
    },
    {
        "question": "Who founded the city that hosted the 1980 Summer Olympics?",
        "triples": [],
        "candidate_triples": [
            "A. <Moscow; founded by; Yuri Dolgoruky>",
            "B. <1980 Summer Olympics; hosted by; Moscow>",
            "C. <Moscow; lies on; Moskva River>",
            "D. <Peru; capital; Lima>",
            "E. <Aristotle; student of; Plato>",
        ],
        "answer": "B",
        "cot_answer": "The host city is the bridge entity. The answer is: B.",
    },
    {
        "question": "Who founded the city that hosted the 1980 Summer Olympics?",
        "triples": ["<1980 Summer Olympics; hosted by; Moscow>"],
        "candidate_triples": [
            "A. <Moscow; lies on; Moskva River>",
            "B. <1980 Summer Olympics; boycotted by; 66 countries>",
            "C. <Moscow; founded by; Yuri Dolgoruky>",
            "D. <Napoleon; died on; Saint Helena>",
            "E. <Finland; official language; Finnish>",
        ],
        "answer": "C",
        "cot_answer": "Moscow's founder answers the question. The answer is: C.",
    },
    {
        "question": "In which mountain range does the river that flows through Vienna rise?",
        "triples": [],
        "candidate_triples": [
            "A. <Danube; rises in; Black Forest>",
            "B. <Vienna; lies on; Danube>",
            "C. <Danube; empties into; Black Sea>",
            "D. <Moscow; founded by; Yuri Dolgoruky>",
            "E. <Spain; borders; France and Portugal>",
        ],
        "answer": "B",
        "cot_answer": "Vienna's river comes before its source. The answer is: B.",
    },
    {
        "question": "In which mountain range does the river that flows through Vienna rise?",
        "triples": ["<Vienna; lies on; Danube>"],
        "candidate_triples": [
            "A. <Danube; empties into; Black Sea>",
            "B. <Danube; rises in; Black Forest>",
            "C. <Vienna; capital of; Austria>",
            "D. <telephone; invented by; Alexander Graham Bell>",
            "E. <Tagus; empties into; Atlantic Ocean>",
        ],
        "answer": "B",
        "cot_answer": "The Danube's source range answers the question — not its mouth. "
                      "The answer is: B.",
    },
    {
        "question": "What currency is used in the country whose capital is Ottawa?",
        "triples": [],
        "candidate_triples": [
            "A. <Canada; currency; Canadian dollar>",
            "B. <Ottawa; capital of; Canada>",
            "C. <Ottawa; located in; Ontario>",
            "D. <Danube; rises in; Black Forest>",
            "E. <Pompeii; destroyed by eruption of; Mount Vesuvius>",
        ],
        "answer": "B",
        "cot_answer": "Resolve the country from its capital first. The answer is: B.",
    },
    {
        "question": "What currency is used in the country whose capital is Ottawa?",
        "triples": ["<Ottawa; capital of; Canada>"],
        "candidate_triples": [
            "A. <Canada; largest city; Toronto>",
            "B. <Canada; currency; Canadian dollar>",
            "C. <Ottawa; located in; Ontario>",
            "D. <1980 Summer Olympics; boycotted by; 66 countries>",
            "E. <Alexander the Great; tutored by; Aristotle>",
        ],
        "answer": "B",
        "cot_answer": "Canada's currency completes the chain. The answer is: B.",
    },
    {
        "question": "What is the longest river of the continent where the Atacama Desert lies?",
        "triples": [],
        "candidate_triples": [
            "A. <Amazon; longest river of; South America>",
            "B. <Atacama Desert; located in; Chile>",
            "C. <Atacama Desert; is; driest nonpolar desert>",
            "D. <Canada; largest city; Toronto>",
            "E. <English fleet against the Armada; commanded by; Lord Howard of Effingham>",
        ],
        "answer": "B",
        "cot_answer": "The desert's country starts the chain toward its continent. "
                      "The answer is: B.",
    },
    {
        "question": "What is the longest river of the continent where the Atacama Desert lies?",
        "triples": ["<Atacama Desert; located in; Chile>"],
        "candidate_triples": [
            "A. <Chile; located in; South America>",
            "B. <Amazon; longest river of; South America>",
            "C. <Chile; capital; Santiago>",
            "D. <Moonlight Sonata; composed by; Ludwig van Beethoven>",
            "E. <Mexico City; built on site of; Tenochtitlan>",
        ],
        "answer": "A",
        "cot_answer": "Chile's continent must come before the river. The answer is: A.",
    },
    {
        "question": "What is the longest river of the continent where the Atacama Desert lies?",
        "triples": ["<Atacama Desert; located in; Chile>",
                    "<Chile; located in; South America>"],
        "candidate_triples": [
            "A. <Chile; capital; Santiago>",
            "B. <Amazon; longest river of; South America>",
            "C. <Amazon; empties into; Atlantic Ocean>",
            "D. <Saint Helena; located in; South Atlantic Ocean>",
            "E. <Louis XIV; succeeded by; Louis XV>",
        ],
        "answer": "B",
        "cot_answer": "South America's longest river answers the question. "
                      "The answer is: B.",
    },
    {
        "question": "Who was the first ruler of the empire whose capital stood where "
                    "Mexico City is today?",
        "triples": [],
        "candidate_triples": [
            "A. <Tenochtitlan; capital of; Aztec Empire>",
            "B. <Mexico City; built on site of; Tenochtitlan>",
            "C. <Aztec Empire; first ruler; Acamapichtli>",
            "D. <Amazon; empties into; Atlantic Ocean>",
            "E. <Plato; founded; the Academy>",
        ],
        "answer": "B",
        "cot_answer": "The buried city under Mexico City starts the chain. "
                      "The answer is: B.",
    },
    {
        "question": "Who was the first ruler of the empire whose capital stood where "
                    "Mexico City is today?",
        "triples": ["<Mexico City; built on site of; Tenochtitlan>"],
        "candidate_triples": [
            "A. <Tenochtitlan; founded in; 1325>",
            "B. <Tenochtitlan; capital of; Aztec Empire>",
            "C. <Aztec Empire; first ruler; Acamapichtli>",
            "D. <Machu Picchu; built by; Inca Empire>",
            "E. <Madrid; largest city of; Spain>",
        ],
        "answer": "B",
        "cot_answer": "The empire must be named before its first ruler. The answer is: B.",
    },
    {
        "question": "Who was the first ruler of the empire whose capital stood where "
                    "Mexico City is today?",
        "triples": ["<Mexico City; built on site of; Tenochtitlan>",
                    "<Tenochtitlan; capital of; Aztec Empire>"],
        "candidate_triples": [
            "A. <Aztec Empire; first ruler; Acamapichtli>",
            "B. <Tenochtitlan; founded in; 1325>",
            "C. <Aztec Empire; fell in; 1521>",
            "D. <Yuri Dolgoruky; founded; Moscow>",
            "E. <Finnish; language family; Uralic>",
        ],
        "answer": "A",
        "cot_answer": "The Aztec Empire's first ruler completes the chain. "
                      "The answer is: A.",
    },
    {
        "question": "In which country did the inventor of the telephone die?",
        "triples": [],
        "candidate_triples": [
            "A. <Alexander Graham Bell; place of death; Beinn Bhreagh, Nova Scotia>",
            "B. <telephone; invented by; Alexander Graham Bell>",
            "C. <Alexander Graham Bell; born in; Edinburgh>",
            "D. <Aztec Empire; fell in; 1521>",
            "E. <Spanish Armada; sent by; Philip II of Spain>",
        ],
        "answer": "B",
        "cot_answer": "The inventor is the bridge entity. The answer is: B.",
    },
    {
        "question": "In which country did the inventor of the telephone die?",
        "triples": ["<telephone; invented by; Alexander Graham Bell>"],
        "candidate_triples": [
            "A. <Alexander Graham Bell; born in; Edinburgh>",
            "B. <Alexander Graham Bell; place of death; Beinn Bhreagh, Nova Scotia>",
            "C. <telephone; patented in; 1876>",
            "D. <Chile; located in; South America>",
            "E. <Mount Vesuvius; last erupted in; 1944>",
        ],
        "answer": "B",
        "cot_answer": "Where Bell died must be found before its country. "
                      "The answer is: B.",
    },
    {
        "question": "In which country did the inventor of the telephone die?",
        "triples": ["<telephone; invented by; Alexander Graham Bell>",
                    "<Alexander Graham Bell; place of death; Beinn Bhreagh, Nova Scotia>"],
        "candidate_triples": [
            "A. <Nova Scotia; province of; Canada>",
            "B. <Alexander Graham Bell; born in; Edinburgh>",
            "C. <telephone; patented in; 1876>",
            "D. <Ottawa; located in; Ontario>",
            "E. <Lord Howard of Effingham; commanded; English fleet against the Armada>",
        ],
        "answer": "A",
        "cot_answer": "Nova Scotia's country is the final hop. The answer is: A.",
    },
    {
        "question": "What is the largest city of the country that borders both France "
                    "and Portugal?",
        "triples": [],
        "candidate_triples": [
            "A. <Madrid; largest city of; Spain>",
            "B. <Spain; borders; France and Portugal>",
            "C. <Spain; capital; Madrid>",
            "D. <Nova Scotia; province of; Canada>",
            "E. <Napoleon; exiled to; Saint Helena>",
        ],
        "answer": "B",
        "cot_answer": "Identify the doubly-bordering country first. The answer is: B.",
    },
    {
        "question": "What is the largest city of the country that borders both France "
                    "and Portugal?",
        "triples": ["<Spain; borders; France and Portugal>"],
        "candidate_triples": [
            "A. <Madrid; largest city of; Spain>",
            "B. <Spain; currency; euro>",
            "C. <Portugal; capital; Lisbon>",
            "D. <Amazon; longest river of; South America>",
            "E. <Pompeii; destroyed by eruption of; Mount Vesuvius>",
        ],
        "answer": "A",
        "cot_answer": "Spain's largest city answers the question. The answer is: A.",
    },
    {
        "question": "To which language family does the official language of Finland belong?",
        "triples": [],
        "candidate_triples": [
            "A. <Finnish; language family; Uralic>",
            "B. <Finland; official language; Finnish>",
            "C. <Finland; capital; Helsinki>",
            "D. <Spain; currency; euro>",
            "E. <Moscow; lies on; Moskva River>",
        ],
        "answer": "B",
        "cot_answer": "The language must be fixed before its family. The answer is: B.",
    },
    {
        "question": "To which language family does the official language of Finland belong?",
        "triples": ["<Finland; official language; Finnish>"],
        "candidate_triples": [
            "A. <Finland; capital; Helsinki>",
            "B. <Finnish; language family; Uralic>",
            "C. <Finnish; co-official with; Swedish>",
            "D. <Tenochtitlan; founded in; 1325>",
            "E. <Danube; empties into; Black Sea>",
        ],
        "answer": "B",
        "cot_answer": "Finnish's language family completes the chain. The answer is: B.",
    },
    {
        "question": "Who commanded the English fleet that defeated the Armada sent by "
                    "Philip II?",
        "triples": [],
        "candidate_triples": [
            "A. <English fleet against the Armada; commanded by; Lord Howard of Effingham>",
            "B. <Spanish Armada; sent by; Philip II of Spain>",
            "C. <Spanish Armada; defeated in; 1588>",
            "D. <Finnish; co-official with; Swedish>",
            "E. <Palace of Versailles; built under; Louis XIV>",
        ],
        "answer": "B",
        "cot_answer": "Confirm which Armada Philip II sent before its opponents. "
                      "The answer is: B.",
    },
    {
        "question": "Who commanded the English fleet that defeated the Armada sent by "
                    "Philip II?",
        "triples": ["<Spanish Armada; sent by; Philip II of Spain>"],
        "candidate_triples": [
            "A. <Spanish Armada; defeated in; 1588>",
            "B. <English fleet against the Armada; commanded by; Lord Howard of Effingham>",
            "C. <Philip II of Spain; ruled from; 1556>",
            "D. <Alexander Graham Bell; place of death; Beinn Bhreagh, Nova Scotia>",
            "E. <Vienna; capital of; Austria>",
        ],
        "answer": "B",
        "cot_answer": "The fleet's commander is the asked fact. The answer is: B.",
    },
    {
        "question": "In which ocean is the island where Napoleon died in exile?",
        "triples": [],
        "candidate_triples": [
            "A. <Saint Helena; located in; South Atlantic Ocean>",
            "B. <Napoleon; died on; Saint Helena>",
            "C. <Napoleon; first exiled to; Elba>",
            "D. <Philip II of Spain; ruled from; 1556>",
            "E. <Canada; currency; Canadian dollar>",
        ],
        "answer": "B",
        "cot_answer": "The island of his death comes before its ocean — and it is not "
                      "Elba. The answer is: B.",
    },
    {
        "question": "In which ocean is the island where Napoleon died in exile?",
        "triples": ["<Napoleon; died on; Saint Helena>"],
        "candidate_triples": [
            "A. <Saint Helena; located in; South Atlantic Ocean>",
            "B. <Napoleon; first exiled to; Elba>",
            "C. <Saint Helena; is a; British Overseas Territory>",
            "D. <Black Forest; located in; Germany>",
            "E. <Acamapichtli; first ruler of; Aztec Empire>",
        ],
        "answer": "A",
        "cot_answer": "Saint Helena's ocean completes the chain. The answer is: A.",
    },
    {
        "question": "Into which ocean does the river that flows through Lisbon empty?",
        "triples": [],
        "candidate_triples": [
            "A. <Tagus; empties into; Atlantic Ocean>",
            "B. <Lisbon; lies on; Tagus>",
            "C. <Tagus; rises in; Spain>",
            "D. <Saint Helena; is a; British Overseas Territory>",
            "E. <1980 Summer Olympics; hosted by; Moscow>",
        ],
        "answer": "B",
        "cot_answer": "Lisbon's river starts the chain. The answer is: B.",
    },
    {
        "question": "Into which ocean does the river that flows through Lisbon empty?",
        "triples": ["<Lisbon; lies on; Tagus>"],
        "candidate_triples": [
            "A. <Tagus; rises in; Spain>",
            "B. <Tagus; empties into; Atlantic Ocean>",
            "C. <Portugal; capital; Lisbon>",
            "D. <Moscow; founded by; Yuri Dolgoruky>",
            "E. <Peru; official language; Spanish>",
        ],
        "answer": "B",
        "cot_answer": "The Tagus's mouth answers the question — not its source. "
                      "The answer is: B.",
    },
    {
        "question": "Who succeeded the king who built the Palace of Versailles?",
        "triples": [],
        "candidate_triples": [
            "A. <Louis XIV; succeeded by; Louis XV>",
            "B. <Palace of Versailles; built under; Louis XIV>",
            "C. <Palace of Versailles; located near; Paris>",
            "D. <Tagus; empties into; Atlantic Ocean>",
            "E. <Aztec Empire; first ruler; Acamapichtli>",
        ],
        "answer": "B",
        "cot_answer": "The building king must be identified first. The answer is: B.",
    },
    {
        "question": "Who succeeded the king who built the Palace of Versailles?",
        "triples": ["<Palace of Versailles; built under; Louis XIV>"],
        "candidate_triples": [
            "A. <Louis XIV; reigned for; 72 years>",
            "B. <Louis XIV; succeeded by; Louis XV>",
            "C. <Palace of Versailles; located near; Paris>",
            "D. <Spain; borders; France and Portugal>",
            "E. <Finland; official language; Finnish>",
        ],
        "answer": "B",
        "cot_answer": "Louis XIV's successor is the asked fact. The answer is: B.",
    },
    {
        "question": "In which Italian region is the volcano that destroyed Pompeii?",
        "triples": [],
        "candidate_triples": [
            "A. <Mount Vesuvius; located in; Campania>",
            "B. <Pompeii; destroyed by eruption of; Mount Vesuvius>",
            "C. <Mount Vesuvius; last erupted in; 1944>",
            "D. <Louis XIV; reigned for; 72 years>",
            "E. <Ottawa; capital of; Canada>",
        ],
        "answer": "B",
        "cot_answer": "The volcano must be identified before its region. "
                      "The answer is: B.",
    },
    {
        "question": "In which Italian region is the volcano that destroyed Pompeii?",
        "triples": ["<Pompeii; destroyed by eruption of; Mount Vesuvius>"],
        "candidate_triples": [
            "A. <Mount Vesuvius; last erupted in; 1944>",
            "B. <Mount Vesuvius; located in; Campania>",
            "C. <Pompeii; buried in; AD 79>",
            "D. <Madrid; largest city of; Spain>",
            "E. <Amazon; longest river of; South America>",
        ],
        "answer": "B",
        "cot_answer": "Vesuvius's region answers the question. The answer is: B.",
    },
    {
        "question": "Who taught the philosopher who tutored Alexander the Great?",
        "triples": [],
        "candidate_triples": [
            "A. <Aristotle; student of; Plato>",
            "B. <Alexander the Great; tutored by; Aristotle>",
            "C. <Plato; founded; the Academy>",
            "D. <Pompeii; buried in; AD 79>",
            "E. <Lisbon; lies on; Tagus>",
        ],
        "answer": "B",
        "cot_answer": "The tutor must be identified before his own teacher. "
                      "The answer is: B.",
    },
    {
        "question": "Who taught the philosopher who tutored Alexander the Great?",
        "triples": ["<Alexander the Great; tutored by; Aristotle>"],
        "candidate_triples": [
            "A. <Plato; founded; the Academy>",
            "B. <Aristotle; student of; Plato>",
            "C. <Aristotle; founded; the Lyceum>",
            "D. <Napoleon; first exiled to; Elba>",
            "E. <Machu Picchu; located in; Peru>",
        ],
        "answer": "B",
        "cot_answer": "Aristotle's teacher answers the question. The answer is: B.",
    },
]
